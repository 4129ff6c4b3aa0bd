"""The decoder-only LM of the port: layers, attention, the block stack and
the top-level LM.  So far the dense ``('attn', 'mlp')`` block, which the
serving path runs; the other block kinds come with their slices."""
