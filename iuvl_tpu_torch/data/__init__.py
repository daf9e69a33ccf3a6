"""Host-side data helpers of the port: tokenizers, class names, prompt
templates, the interactive eval's prompt helpers, and the dataset registry
with the stage-2 instruction stream (the other loaders are not ported
yet)."""
