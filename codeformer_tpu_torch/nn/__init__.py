"""Building blocks: VQGAN blocks and the transformer layer."""
