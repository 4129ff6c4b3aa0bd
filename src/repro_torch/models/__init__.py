"""The decoder-only LM of the port: layers, attention, the MoE FFN, the
Mamba, mLSTM and sLSTM mixers, the block stack, the modality frontend
stubs and the top-level LM.  Every block kind serves; the attention
blocks (MLP or MoE FFN) also train."""
