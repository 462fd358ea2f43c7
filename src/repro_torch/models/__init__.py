"""The LM stack of the port: layers, backbone and the ``Model`` facade
for attention + MLP language models (serving: prefill and decode)."""
