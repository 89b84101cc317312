"""The functional ops BERT and the vision models (LeNet, ResNet) reach.

Port of the matching part of ``paddle_tpu/nn/functional.py`` (and
``flatten`` from ``paddle_tpu/ops/manipulation.py``). Layouts follow
the JAX package, not PyTorch's habits: ``linear``'s W is (in, out) and
``y = x @ W + b`` (the reference fc/mul op); attention takes
(B, L, H, D); ``fused_linear_cross_entropy``'s W is (V, H), the
embedding layout; convolution and pooling take NCHW or NHWC (the
channel axis moved around PyTorch's NCHW op, as JAX's ``channel_last``)
and a conv weight (C_out, C_in/groups, kh, kw) either way, and padding
as ints, pairs or "SAME"/"VALID" (``jax.lax.padtype_to_pads``'s split,
the odd pixel at the end). Each op
passes its inputs through ``amp.maybe_cast_inputs`` under the JAX op
name, so ``auto_cast`` casts the same ops as in the JAX package
(``linear``/``matmul``/``conv2d`` down, ``layer_norm``/
``softmax_with_cross_entropy`` up, the rest untouched).

Batch norm computes its statistics as the JAX package does: the mean
and the BIASED variance (``jnp.var``), taken in f32 for a bf16/f16
input and rounded back to its type, and running statistics updated as
``momentum*running + (1-momentum)*batch`` with Paddle's momentum (0.9:
the weight of the OLD value, the opposite of PyTorch's convention).
Under O1 its input is the bf16 output of a convolution, so it
normalises in bf16 and its f32 scale makes its output f32, as in JAX;
``torch.nn.functional.batch_norm`` would use the unbiased variance for
the running update and keep bf16. Python scalars in bf16 arithmetic are
rounded to bf16 first, as JAX's weak types are.

``add``, ``subtract``, ``multiply`` and ``divide`` are the JAX
package's elementwise ops (``ops/math.py:44``), which its ``Tensor``
arithmetic reaches (``framework/math_op_patch.py:22-50``): under O2
they cast their floating inputs down like every op that is not
black-listed. The port's models call them where the JAX models write
``a + b`` on tensors (residuals, the embedding sum, the loss sum);
PyTorch's own ``+`` would promote ``f32 + bf16`` to f32.

Attention, the MLM head's loss and the pooled embedding bag are the
kernels' entry points (``ops/cuda/flash_attention.py``,
``ops/cuda/fused_xent.py``, ``ops/cuda/fused_embedding.py``): on CUDA
tensors they launch the hand-written kernels, on CPU tensors the plain
versions. Dropout draws its mask from the active step's device
generator (``framework.random``); attention dropout hands the kernel a
64-bit seed drawn from the step's host generator.
"""
from __future__ import annotations

import torch

from ..amp import maybe_cast_inputs
from ..framework.flags import get_flag
from ..framework.random import current_rng
from ..ops.cuda import flash_attention as _fa
from ..ops.cuda import fused_embedding as _fe
from ..ops.cuda import fused_xent as _fx
from ..parallel import ring as _ring

__all__ = ["add", "subtract", "multiply", "divide", "linear", "matmul", "embedding", "fused_embedding_seq_pool",
           "dropout", "gelu", "tanh", "relu", "layer_norm", "cross_entropy",
           "scaled_dot_product_attention", "fused_linear_cross_entropy",
           "conv2d", "max_pool2d", "adaptive_avg_pool2d", "batch_norm",
           "flatten", "mark_subsequent_mask", "is_subsequent_mask"]

_LOW = (torch.bfloat16, torch.float16)


def add(x, y):
    """``x + y`` as the JAX ``add`` op (cast by the amp rule)."""
    x, y = maybe_cast_inputs("add", [x, y])
    return torch.add(x, y)


def subtract(x, y):
    x, y = maybe_cast_inputs("subtract", [x, y])
    return torch.sub(x, y)


def multiply(x, y):
    x, y = maybe_cast_inputs("multiply", [x, y])
    return torch.mul(x, y)


def divide(x, y):
    x, y = maybe_cast_inputs("divide", [x, y])
    return torch.div(x, y)


def linear(x, weight, bias=None):
    """``x @ weight + bias`` with weight (in_features, out_features)."""
    if x.dim() < 1 or weight.dim() != 2 or x.shape[-1] != weight.shape[0]:
        raise ValueError(
            f"linear: input features {tuple(x.shape)}[-1] must match "
            f"weight rows {tuple(weight.shape)}: W is (in_features, "
            f"out_features) in this framework (reference fc/mul op)")
    x, weight, bias = maybe_cast_inputs("linear", [x, weight, bias])
    out = torch.matmul(x, weight)
    if bias is not None:
        out = out + bias
    return out


def matmul(x, y, transpose_x=False, transpose_y=False):
    x, y = maybe_cast_inputs("matmul", [x, y])
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def embedding(x, weight, padding_idx=None):
    """Rows of ``weight`` gathered by ``x`` (``jnp.take``: a negative id
    counts from the end); rows whose id equals ``padding_idx`` give 0
    and pass no gradient."""
    if x.is_floating_point():
        raise ValueError(f"embedding: ids must be an integer tensor, got "
                         f"{x.dtype}")
    (weight,) = maybe_cast_inputs("embedding_fn", [weight])
    ids = x.long()
    ids = torch.where(ids < 0, ids + weight.shape[0], ids)
    out = torch.nn.functional.embedding(ids, weight)
    if padding_idx is not None:
        out = torch.where((x == padding_idx).unsqueeze(-1), 0.0, out)
    return out


def fused_embedding_seq_pool(table, ids, combiner="sum", padding_idx=None):
    """Pooled bag-of-ids embedding (``fused_embedding_seq_pool_op``):
    table (V, D), ids (B, S) -> (B, D) through the embedding bag kernel.
    Ids equal to ``padding_idx`` (when >= 0) or negative contribute
    nothing; ``combiner`` is sum, mean or sqrtn, and mean/sqrtn divide by
    the count of VALID ids. An id >= V reads row V - 1."""
    if combiner not in _fe.COMBINERS:
        raise ValueError(f"unknown combiner {combiner!r}")
    (table,) = maybe_cast_inputs("fused_embedding_seq_pool", [table])
    if padding_idx is not None and padding_idx >= 0:
        ids = torch.where(ids == padding_idx, -1, ids)
    return _fe.fused_embedding_bag(table, ids, combiner)


def dropout(x, p=0.5, training=True):
    """Zero each element with probability ``p`` and divide the kept ones
    by 1 - p (``upscale_in_train``); the mask comes from the active
    step's device generator."""
    if not training or p == 0.0:
        return x
    (x,) = maybe_cast_inputs("dropout", [x])
    keep = torch.rand(x.shape, generator=current_rng(x.device).generator,
                      device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def gelu(x):
    """The exact (erf) gelu."""
    (x,) = maybe_cast_inputs("gelu", [x])
    return torch.nn.functional.gelu(x)


def tanh(x):
    (x,) = maybe_cast_inputs("tanh", [x])
    return torch.tanh(x)


def relu(x):
    (x,) = maybe_cast_inputs("relu", [x])
    return torch.relu(x)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    x, weight, bias = maybe_cast_inputs("layer_norm", [x, weight, bias])
    return torch.nn.functional.layer_norm(x, tuple(normalized_shape),
                                          weight, bias, epsilon)


def _reduce_loss(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """Softmax cross-entropy over ``axis`` (``paddle_tpu/nn/
    functional.py:754-802``): log-softmax of ``input`` (with
    ``use_softmax=False``, ``log(max(input, 1e-30))``); soft labels
    (``-sum(label * logp)``, mean over rows for ``"mean"``); hard labels
    (integer class ids, the class axis dropped or of size 1), optionally
    smoothed through a one-hot (``(1 - s) * onehot + s / classes``), rows
    labelled ``ignore_index`` set to 0. Class ``weight`` scales each row by
    its label's weight, and the weighted mean divides by the sum of the
    valid rows' weights (at least 1e-12); the plain mean by their count
    (at least 1). ``reduction`` "mean", "sum" or "none"."""
    (input,) = maybe_cast_inputs("softmax_with_cross_entropy", [input])
    if use_softmax:
        logp = torch.log_softmax(input, dim=axis)
    else:
        logp = torch.log(torch.clamp(input, min=1e-30))
    n_classes = input.shape[axis]
    if soft_label:
        loss = -(label.to(logp.dtype) * logp).sum(dim=axis)
        return _reduce_loss(loss, reduction)
    if label.is_floating_point():
        raise ValueError(
            f"cross_entropy: hard labels must be integer class ids, got "
            f"{label.dtype} {tuple(label.shape)}; pass soft_label=True for "
            "probability targets")
    lbl = label
    if lbl.dim() == logp.dim():
        if lbl.shape[axis] != 1:
            raise ValueError(
                f"cross_entropy: cannot squeeze axis {axis} of label "
                f"shape {tuple(label.shape)}: its size is not 1")
        lbl = lbl.squeeze(axis)
    elif lbl.dim() != logp.dim() - 1:
        raise ValueError(
            f"cross_entropy: label shape {tuple(label.shape)} must be "
            f"logits shape {tuple(input.shape)} without the class axis "
            f"(or with a trailing 1)")
    ax = axis % logp.dim()
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, torch.zeros_like(lbl)).long()
    if label_smoothing > 0.0:
        onehot = torch.nn.functional.one_hot(safe, n_classes).to(logp.dtype)
        onehot = torch.where(valid.unsqueeze(-1), onehot,
                             torch.zeros_like(onehot)).movedim(-1, ax)
        soft = onehot * (1 - label_smoothing) + label_smoothing / n_classes
        loss = -(soft * logp).sum(dim=ax)
    else:
        loss = -logp.gather(ax, safe.unsqueeze(ax)).squeeze(ax)
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if weight is not None:
        w = weight.to(loss.dtype)[safe]
        loss = loss * w
        if reduction == "mean":
            return loss.sum() / torch.clamp(
                torch.where(valid, w, torch.zeros_like(w)).sum(), min=1e-12)
    if reduction == "mean":
        return loss.sum() / valid.sum().to(loss.dtype).clamp(min=1.0)
    return _reduce_loss(loss, reduction)


# the subsequent mask's tag: the tensor's version counter when it was
# made (a host-side integer; an in-place change bumps it)
_SUBSEQUENT_TAG = "_subsequent_mask_version"


def mark_subsequent_mask(mask):
    """Tag ``mask``, an (L, L) float tensor that is 0 on and below the
    diagonal and -1e9 above it (``Transformer.
    generate_square_subsequent_mask``), so that attention runs it as
    causal masking; returns it. Nothing reads its values: the tag is an
    attribute of the tensor holding its version counter, so a copy, a
    conversion or an in-place change leaves a mask without a valid tag
    (a per-query mask)."""
    setattr(mask, _SUBSEQUENT_TAG, mask._version)
    return mask


def is_subsequent_mask(mask, q_len, kv_len):
    """Whether ``mask`` is a tagged, unchanged subsequent mask of shape
    (q_len, kv_len) with q_len == kv_len; a host-side test, no device
    read."""
    return (q_len == kv_len and tuple(mask.shape) == (q_len, kv_len)
            and getattr(mask, _SUBSEQUENT_TAG, None) == mask._version)


def _mask_route(mask, batch, q_len, kv_len):
    """What attention does with ``mask``, by its kind, from its shape,
    dtype and tag alone (no device read): ("causal", None) for the
    subsequent mask (the kernels' causal masking; scores of -1e9 and
    -inf give the same softmax, since a causal row keeps its diagonal);
    ("key", bias) for a key-padding mask, the (B, Lk) f32 key bias that
    rides the flash kernels (a boolean one through ``kv_mask_bias``, 0
    or -1e30; a float one as given, as ``_xla_attention`` adds it); and
    ("per_query", mask) for every other mask, and for a float key mask
    that requires grad (the kernels give the key bias no gradient),
    which then goes as (B, 1, 1, Lk), so that it masks keys as the
    kernels' form does."""
    if is_subsequent_mask(mask, q_len, kv_len):
        return "causal", None
    bias = _fa.kv_mask_bias(mask, batch, kv_len)
    if bias is not None:
        return "key", bias
    m = _fa.key_padding_view(mask, batch, kv_len)
    if m is not None and mask.dtype != torch.bool:
        if mask.requires_grad:
            return "per_query", m[:, None, None, :]
        return "key", m.to(torch.float32).contiguous()
    return "per_query", mask


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True):
    """Attention over (B, L, H, D) tensors through a flash kernel, with
    dropout inside the kernel while training. With
    ``FLAGS_flash_short_seq`` on and a shape the short-sequence kernels
    take (``flash_attention.short_ok``: Lq == Lk, 128 <= L <= 512,
    L % 128 == 0) it runs them, as the JAX package's ``_short_choice``
    does without its TPU autotune, for f32, bf16 and f16 alike;
    otherwise the streaming kernel. Each branch launches a kernel: this
    is dispatch by shape.

    ``attn_mask`` is dispatched by its kind (``_mask_route``, from its
    shape, dtype and tag, never its values): the subsequent mask of
    ``Transformer.generate_square_subsequent_mask`` runs as the
    kernels' causal masking with no bias; a key-padding mask, boolean
    (True = attend) or float (added to the scores), of shape (B, Lk),
    (B, 1, Lk) or (B, 1, 1, Lk), rides the streaming kernels as a
    (B, Lk) f32 bias, with dropout and causal masking too, and with the
    short-sequence flag on (the JAX short route needs no mask); any other
    mask (per-query, or a float mask that requires grad) runs
    ``flash_attention.per_query_attention``, the plain attention the JAX
    package computes for it outside Pallas, counted as
    ``attention_per_query_plain``.

    Inside an active ``parallel.sequence_parallel`` scope q, k and v are
    this rank's sequence shards and attention is ring attention over the
    scope's axis (``parallel.ring``), with a key-padding mask riding the
    ring beside its k/v block (``flash_attention.py:898-945``) and the
    subsequent mask as causal attention; a per-query mask raises
    ``ValueError`` there, as in the JAX package without
    ``FLAGS_sp_mask_fallback``. The ring runs at dropout 0 only:
    attention dropout under sequence parallelism raises
    ``NotImplementedError`` (JAX computes it replicated, outside the
    ring; the port does not copy that)."""
    query, key, value = maybe_cast_inputs("sdpa", [query, key, value])
    b, lq, lk = query.shape[0], query.shape[1], key.shape[1]
    route, arg = ("none", None) if attn_mask is None else \
        _mask_route(attn_mask, b, lq, lk)
    bias = arg if route == "key" else None
    if route == "causal":
        attn_mask, is_causal = None, True
    p = float(dropout_p) if training else 0.0
    sp = _ring.active_sequence_parallel()
    if sp is not None:
        if route == "per_query":
            raise ValueError(
                "sequence_parallel attention received a query-dependent "
                "mask it cannot ride the ring with: pass is_causal=True "
                "plus a (B, L) key-padding mask instead")
        if p > 0.0:
            raise NotImplementedError(
                f"attention dropout ({p}) under sequence parallelism: ring "
                f"attention runs at dropout 0; set the attention dropout "
                f"to 0 (hidden dropout is unaffected)")
        axis, _, _, mesh = sp
        return _ring._ring_local(query, key, value, axis, is_causal, bias,
                                 mesh, key=attn_mask)
    seed = current_rng(query.device).next_seed() if p > 0.0 else 0
    if route == "per_query":
        return _fa.per_query_attention(query, key, value, arg,
                                       causal=is_causal, dropout_p=p,
                                       seed=seed)
    if bias is None and get_flag("flash_short_seq") \
            and _fa.short_ok(query, key):
        return _fa.flash_attention_short(query, key, value, causal=is_causal,
                                         dropout_p=p, seed=seed)
    return _fa.flash_attention(query, key, value, causal=is_causal,
                               dropout_p=p, seed=seed, bias=bias)


def fused_linear_cross_entropy(h, weight, bias, label, ignore_index=-100):
    """Mean softmax cross-entropy of ``h @ weight.T + bias`` without
    materialising the (rows, vocab) logits; weight is (V, H)."""
    h, weight, bias = maybe_cast_inputs("fused_linear_cross_entropy",
                                        [h, weight, bias])
    return _fx.fused_linear_cross_entropy(h, weight, bias, label,
                                          ignore_index=ignore_index)


# ---------------------------------------------------------------------------
# convolution, pooling, batch norm (the vision models)
# ---------------------------------------------------------------------------
def _tuple_n(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(int(x) for x in v)


def _pads(padding, n, sizes=None, window=None, stride=None):
    """[(low, high)] per spatial dim from an int, n ints, 2n ints or n
    pairs (JAX's ``_conv_padding``), or a string: "VALID" (none),
    "SAME" or "SAME_LOWER" (``jax.lax.padtype_to_pads`` over the spatial
    ``sizes`` with the (dilated) ``window`` and ``stride``: enough to
    give ceil(size / stride) outputs, the odd pixel at the end, or at
    the start for "SAME_LOWER")."""
    if isinstance(padding, str):
        kind = padding.upper()
        if kind == "VALID":
            return [(0, 0)] * n
        if kind not in ("SAME", "SAME_LOWER"):
            raise ValueError(f"Unknown padding type: {padding}")
        out = []
        for size, k, st in zip(sizes, window, stride):
            total = max((-(-size // st) - 1) * st + k - size, 0)
            lo = total // 2 if kind == "SAME" else total - total // 2
            out.append((lo, total - lo))
        return out
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n:
        if isinstance(padding[0], (list, tuple)):
            return [tuple(int(v) for v in p) for p in padding]
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * n:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    raise ValueError(f"Bad padding {padding}")


def _nchw(x, data_format):
    """An NHWC input as NCHW (the torch ops' layout); NCHW as it is."""
    if data_format == "NHWC":
        return x.permute(0, 3, 1, 2)
    if data_format != "NCHW":
        raise ValueError(f"data_format {data_format!r}: NCHW or NHWC")
    return x


def _back(x, data_format):
    """An NCHW result in the caller's ``data_format``."""
    return x.permute(0, 2, 3, 1) if data_format == "NHWC" else x


def _pad_spatial(x, pads, value):
    """Pad the two trailing (H, W) dims of an NCHW tensor."""
    (ht, hb), (wl, wr) = pads
    return torch.nn.functional.pad(x, (wl, wr, ht, hb), value=value)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    """Convolution of an NCHW or NHWC (``data_format``) input, weight
    (C_out, C_in/groups, kh, kw) either way, the output in the input's
    layout; the bias is added after the product, as the JAX package
    does. ``padding`` as ``_pads`` takes it ("SAME" and "VALID" over the
    dilated kernel)."""
    if x.dim() != 4 or weight.dim() != 4:
        raise ValueError(f"conv2d: expected rank-4 input and weight, got "
                         f"input {tuple(x.shape)} and weight "
                         f"{tuple(weight.shape)}")
    x = _nchw(x, data_format)
    if x.shape[1] != weight.shape[1] * groups:
        raise ValueError(
            f"conv2d: input {tuple(x.shape)} (C_in={x.shape[1]}) is "
            f"incompatible with weight {tuple(weight.shape)}: the weight "
            f"layout is (C_out, C_in/groups, kh, kw) and needs C_in == "
            f"{weight.shape[1]} * groups({groups})")
    x, weight, bias = maybe_cast_inputs("conv2d", [x, weight, bias])
    stride, dilation = _tuple_n(stride, 2), _tuple_n(dilation, 2)
    window = [(k - 1) * d + 1 for k, d in zip(weight.shape[2:], dilation)]
    pads = _pads(padding, 2, x.shape[2:], window, stride)
    if all(lo == hi for lo, hi in pads):
        out = torch.nn.functional.conv2d(x, weight, None, stride,
                                         [lo for lo, _ in pads], dilation,
                                         groups)
    else:
        out = torch.nn.functional.conv2d(_pad_spatial(x, pads, 0.0), weight,
                                         None, stride, 0, dilation, groups)
    out = _back(out, data_format)
    if bias is not None:
        shape = (1, 1, 1, -1) if data_format == "NHWC" else (1, -1, 1, 1)
        out = out + bias.reshape(shape)
    return out


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW"):
    """Max over windows of an NCHW or NHWC tensor padded with -inf
    (``padding`` as ``_pads`` takes it); ``ceil_mode`` widens the high
    padding so that a partial last window counts. ``return_mask`` is
    accepted and only the pooled tensor returned, as the JAX package
    does (``paddle_tpu/nn/functional.py:487-490``)."""
    (x,) = maybe_cast_inputs("max_pool2d", [x])
    x = _nchw(x, data_format)
    kernel = _tuple_n(kernel_size, 2)
    stride = _tuple_n(stride if stride is not None else kernel_size, 2)
    pads = _pads(padding, 2, x.shape[2:], kernel, stride)
    if ceil_mode:
        for i in range(2):
            size = x.shape[2 + i] + pads[i][0] + pads[i][1]
            rem = (size - kernel[i]) % stride[i]
            if rem:
                pads[i] = (pads[i][0], pads[i][1] + stride[i] - rem)
    if any(p for pair in pads for p in pair):
        x = _pad_spatial(x, pads, float("-inf"))
    return _back(torch.nn.functional.max_pool2d(x, kernel, stride),
                 data_format)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    """Mean over H, then over W (axes 2, 3 of NCHW, 1, 2 of NHWC), into
    ``output_size`` bins: a reshape where the size divides, variable
    windows elsewhere (as JAX)."""
    (x,) = maybe_cast_inputs("adaptive_avg_pool2d", [x])
    sizes = (output_size,) * 2 if isinstance(output_size, int) \
        else tuple(output_size)
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"data_format {data_format!r}: NCHW or NHWC")
    dims = (1, 2) if data_format == "NHWC" else (2, 3)
    for dim, o in zip(dims, sizes):
        n = x.shape[dim]
        o = n if o is None else int(o)
        if n % o == 0:
            x = x.reshape(x.shape[:dim] + (o, n // o) + x.shape[dim + 1:])
            x = x.mean(dim=dim + 1)
        else:
            segs = []
            for i in range(o):
                lo, hi = (i * n) // o, ((i + 1) * n + o - 1) // o
                segs.append(x.narrow(dim, lo, hi - lo).mean(dim=dim,
                                                            keepdim=True))
            x = torch.cat(segs, dim=dim)
    return x


def _weak(value, like):
    """A Python scalar as JAX's weak type meets an array: rounded to its
    dtype. Returned as a Python float (PyTorch then computes in f32 and
    rounds once, as XLA does for bf16), not as a tensor on the device:
    making a CUDA tensor from host data synchronises the stream."""
    return torch.tensor(value, dtype=like.dtype).item()


def _bn_shape(x, axis):
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    return shape


def _batch_norm_train(x, weight, bias, epsilon, axis):
    axes = [i for i in range(x.dim()) if i != axis]
    shape = _bn_shape(x, axis)
    if x.dtype in _LOW:
        # jnp.mean and jnp.var compute in f32 and round to x's type
        x32 = x.float()
        mean32 = x32.mean(dim=axes)
        var = (x32 - mean32.reshape(shape)).square().mean(dim=axes)
        mean, var = mean32.to(x.dtype), var.to(x.dtype)
        centered = x - mean.reshape(shape)
    else:
        mean = x.mean(dim=axes)
        centered = x - mean.reshape(shape)
        var = centered.square().mean(dim=axes)
    out = centered * torch.rsqrt(var.reshape(shape) + _weak(epsilon, var))
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out, mean, var


def _batch_norm_infer(x, mean, var, weight, bias, epsilon, axis):
    shape = _bn_shape(x, axis)
    var = var.reshape(shape)
    out = (x - mean.reshape(shape)) * torch.rsqrt(var + _weak(epsilon, var))
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None):
    """Batch norm over every axis but the channel axis (1 for NC...,
    the last otherwise). Training uses the batch's mean and biased
    variance and updates ``running_mean``/``running_var`` IN PLACE (no
    gradient) as ``momentum*running + (1-momentum)*batch``; otherwise
    (or with ``use_global_stats``) it normalises with the running
    statistics."""
    axis = 1 if data_format in ("NCHW", "NCL", "NCDHW", "NC") \
        else x.dim() - 1
    use_stats = (not training) if use_global_stats is None \
        else use_global_stats
    if use_stats:
        x, running_mean, running_var, weight, bias = maybe_cast_inputs(
            "batch_norm_infer", [x, running_mean, running_var, weight, bias])
        return _batch_norm_infer(x, running_mean, running_var, weight, bias,
                                 epsilon, axis)
    x, weight, bias = maybe_cast_inputs("batch_norm_train", [x, weight, bias])
    out, mean, var = _batch_norm_train(x, weight, bias, epsilon, axis)
    if running_mean is not None:
        with torch.no_grad():
            for run, new in ((running_mean, mean), (running_var, var)):
                run.copy_(run * _weak(momentum, run)
                          + new * _weak(1 - momentum, new))
    return out


def flatten(x, start_axis=0, stop_axis=-1):
    """Merge the axes start_axis..stop_axis into one."""
    (x,) = maybe_cast_inputs("flatten", [x])
    nd = x.dim()
    if nd == 0:
        return x.reshape(1)
    start, stop = start_axis % nd, stop_axis % nd
    return x.reshape(tuple(x.shape[:start]) + (-1,)
                     + tuple(x.shape[stop + 1:]))
