"""Architecture configs: copies of ``repro.configs.archs`` and
``repro.configs.reduced`` (framework-free; kept here so the port imports
nothing of ``repro``)."""
