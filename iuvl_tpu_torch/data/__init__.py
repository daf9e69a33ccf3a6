"""Host-side data helpers of the port: tokenizers, class names, prompt
templates (the dataset layer is not ported yet)."""
