"""Hand-written CUDA kernels of the port, each beside its plain torch
version.  ``duct_exchange`` holds the duct layouts' window, commit and
exchange ops, ``flash_attention`` and ``decode_attention`` the LM's
prefill and decode attention, ``quantize`` and ``topk_compress`` the
training path's lossy cross-pod payload (int8 quantize and dequantize,
magnitude top-k), ``mamba_scan`` the Mamba mixer's selective scan
(jamba's prefill), ``mlstm_attention`` the mLSTM mixer's sequence mix
(xLSTM's prefill); ``build`` builds, loads and counts the launches of all
ten kernels."""
