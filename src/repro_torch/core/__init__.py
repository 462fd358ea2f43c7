"""The IR, the engines and the backend registry."""
