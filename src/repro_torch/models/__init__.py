"""Model code over parameter dicts: the dense attn+mlp decoder with a
paged KV cache."""
