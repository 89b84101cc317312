"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``, built by
``_build`` at first use), each beside its plain PyTorch version and a
launch count (``counters``): ``paged_attention`` (f32 and int8 pools),
``sampling`` (fused top-k + Gumbel-max draw), ``flash_attention``
(streaming forward and backward with in-kernel Philox dropout, and the
short-sequence forms of ``csrc/flash_short.cu``; the streaming ones
take a key-padding bias), ``fused_xent`` (linear + vocabulary
cross-entropy, forward and backward), ``fused_optimizer``
(multi-tensor SGD, Momentum, Adam/AdamW and Lamb, and their static
forms) and ``fused_embedding`` (the pooled embedding bag)."""
