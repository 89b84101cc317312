"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``, built by
``_build`` at first use), each beside its plain PyTorch version and a
launch count (``counters``): ``paged_attention`` (f32 and int8 pools)
and ``sampling`` (fused top-k + Gumbel-max draw)."""
