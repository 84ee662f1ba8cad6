"""The dense Llama-style decoder and its presets."""
