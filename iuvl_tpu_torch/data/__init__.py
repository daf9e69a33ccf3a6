"""Host-side data helpers of the port: tokenizers, class names, prompt
templates, the interactive eval's prompt helpers (the dataset layer is not
ported yet)."""
