"""Shape and layout ops (port of ``paddle_tpu/ops/manipulation.py``).

``split`` takes paddle's count or sections, ``gather`` flattens a
multi-dimensional index, ``scatter`` without ``overwrite`` sums
duplicate rows after zeroing them, ``pad`` reads paddle's pair order
(last spatial dim first). The ops whose output shape depends on the
values (``unique``, ``nonzero``, ``masked_select``,
``unique_consecutive``) compute on the tensor's own device, as
PyTorch can; the JAX package computes them on the host.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..framework import dtype as dtype_mod
from ..framework.op import primitive
from ..framework.tensor import entry
from ._util import as_t, pair, shape_of

__all__ = [
    "reshape", "reshape_", "transpose", "flatten", "squeeze", "unsqueeze",
    "concat", "stack", "unstack", "split", "chunk", "unbind", "tile",
    "expand", "expand_as", "broadcast_to", "broadcast_tensors", "slice",
    "builtins_min", "strided_slice", "getitem", "gather", "gather_nd",
    "take_along_axis", "put_along_axis", "scatter", "scatter_nd_add",
    "scatter_nd", "index_select", "index_sample", "roll", "flip", "rot90",
    "pad", "shard_index", "repeat_interleave", "moveaxis", "swapaxes",
    "as_real", "as_complex", "real", "imag", "unique", "nonzero",
    "masked_select", "masked_fill", "where", "select_scatter", "diagonal",
    "unfold", "tensordot", "crop", "unique_consecutive", "as_strided",
    "view", "view_as", "reverse", "shape", "size", "rank",
    "space_to_depth", "shuffle_channel", "pad_constant_like",
    "crop_tensor", "fill_constant_batch_size_like", "unique_with_counts"]


@entry
def reshape(x, shape, name=None):
    return _reshape(x, shape=shape_of(shape))


@primitive("reshape")
def _reshape(x, shape):
    return torch.reshape(as_t(x), shape)


@entry
def reshape_(x, shape, name=None):
    x.data = torch.reshape(x.data, shape_of(shape))
    return x


@primitive("transpose")
def transpose(x, perm=None, name=None):
    x = as_t(x)
    if perm is None:
        perm = list(range(x.dim()))[::-1]
    return x.permute(*[int(p) for p in perm])


@primitive("flatten")
def flatten(x, start_axis=0, stop_axis=-1, name=None):
    x = as_t(x)
    if x.dim() == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis % x.dim(), stop_axis % x.dim())


@primitive("squeeze")
def squeeze(x, axis=None, name=None):
    x = as_t(x)
    if axis is None:
        return torch.squeeze(x)
    if isinstance(axis, int):
        axis = [axis]
    dims = tuple(a % x.dim() for a in axis if x.shape[a % x.dim()] == 1)
    return torch.squeeze(x, dims) if dims else x


@primitive("unsqueeze")
def unsqueeze(x, axis, name=None):
    out = as_t(x)
    if isinstance(axis, int):
        axis = [axis]
    for a in sorted(int(v) for v in axis):
        out = torch.unsqueeze(out, a)
    return out


@entry
def concat(x, axis=0, name=None):
    a = axis.item() if isinstance(axis, torch.Tensor) else axis
    return _concat(list(x), axis=int(a))


def _same_type(tensors):
    ts = [as_t(t) for t in tensors]
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


@primitive("concat")
def _concat(tensors, axis=0):
    return torch.cat(_same_type(tensors), dim=axis)


@entry
def stack(x, axis=0, name=None):
    return _stack(list(x), axis=axis)


@primitive("stack")
def _stack(tensors, axis=0):
    return torch.stack(_same_type(tensors), dim=axis)


@entry
def unstack(x, axis=0, num=None, name=None):
    n = num if num is not None else as_t(x).shape[axis]
    return list(_unstack(x, axis=axis, num=n))


@primitive("unstack")
def _unstack(x, axis, num):
    return tuple(torch.unbind(as_t(x), dim=axis))


@entry
def split(x, num_or_sections, axis=0, name=None):
    axis = int(axis.item() if isinstance(axis, torch.Tensor) else axis)
    if isinstance(num_or_sections, int):
        return list(_split_even(x, num=num_or_sections, axis=axis))
    sections = [int(s) for s in num_or_sections]
    total = as_t(x).shape[axis]
    if -1 in sections:
        known = sum(s for s in sections if s != -1)
        sections = [total - known if s == -1 else s for s in sections]
    offsets = np.cumsum(sections)[:-1].tolist()
    return list(_split_sections(x, offsets=tuple(offsets), axis=axis))


@primitive("split")
def _split_even(x, num, axis):
    x = as_t(x)
    n = x.shape[axis]
    if n % num:
        raise ValueError(f"split: dimension {axis} of size {n} does not "
                         f"divide into {num} equal parts")
    return tuple(torch.split(x, n // num, dim=axis))


@primitive("split_sections")
def _split_sections(x, offsets, axis):
    x = as_t(x)
    bounds = [0, *offsets, x.shape[axis]]
    return tuple(torch.narrow(x, axis, a, b - a)
                 for a, b in zip(bounds[:-1], bounds[1:]))


@entry
def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


@entry
def unbind(x, axis=0, name=None):
    return unstack(x, axis=axis)


@primitive("tile")
def tile(x, repeat_times, name=None):
    return torch.tile(as_t(x), tuple(int(r) for r in repeat_times))


@primitive("expand")
def _expand(x, shape):
    x = as_t(x)
    lead = len(shape) - x.dim()
    shape = tuple(x.shape[i - lead] if s in (-1, None) and i >= lead else s
                  for i, s in enumerate(shape))
    return x.expand(*shape)


@entry
def expand(x, shape, name=None):
    return _expand(x, shape=shape_of(shape))


@entry
def expand_as(x, y, name=None):
    return _expand(x, shape=tuple(as_t(y).shape))


@entry
def broadcast_to(x, shape, name=None):
    return _expand(x, shape=shape_of(shape))


@entry
def broadcast_tensors(inputs, name=None):
    shape = torch.broadcast_shapes(*[as_t(t).shape for t in inputs])
    return [_expand(t, shape=tuple(shape)) for t in inputs]


def builtins_min(a, b):
    return a if a < b else b


@primitive("slice_op")
def slice(x, axes, starts, ends, name=None):
    out = as_t(x)
    for ax, st, en in zip(axes, starts, ends):
        n = out.shape[ax]
        st, en = int(st), int(en)
        st = n + st if st < 0 else st
        en = n + en if en < 0 else builtins_min(en, n)
        out = torch.narrow(out, ax, st, max(en - st, 0))
    return out


@primitive("strided_slice")
def strided_slice(x, axes, starts, ends, strides, name=None):
    x = as_t(x)
    idx = [builtins.slice(None)] * x.dim()
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        if int(sd) < 0:
            raise NotImplementedError("strided_slice with a negative "
                                      "stride")
        idx[ax] = builtins.slice(int(st), int(en), int(sd))
    return x[tuple(idx)]


def _index(i):
    if isinstance(i, torch.Tensor):
        return i.as_subclass(torch.Tensor)
    if isinstance(i, np.ndarray):
        return torch.from_numpy(i)
    return i


@primitive("getitem")
def getitem(x, idx):
    x = as_t(x)
    if isinstance(idx, tuple):
        idx = tuple(_index(i) for i in idx)
    else:
        idx = _index(idx)
    return torch.Tensor.__getitem__(x, idx)


@primitive("gather")
def gather(x, index, axis=0, name=None):
    x, index = as_t(x), as_t(index)
    if index.dim() > 1:
        index = index.reshape(-1)
    return torch.index_select(x, axis, index.to(torch.int64)) \
        if index.dim() == 1 else torch.select(x, axis, int(index))


@primitive("gather_nd")
def gather_nd(x, index, name=None):
    x, index = as_t(x), as_t(index).to(torch.int64)
    idx = tuple(torch.movedim(index, -1, 0))
    return x[idx]


@primitive("take_along_axis")
def take_along_axis(arr, indices, axis, name=None):
    arr, indices = as_t(arr), as_t(indices).to(torch.int64)
    shape = torch.broadcast_shapes(
        tuple(1 if i == axis % arr.dim() else s
              for i, s in enumerate(arr.shape)),
        tuple(1 if i == axis % arr.dim() else s
              for i, s in enumerate(indices.shape)))
    a_shape = list(shape)
    a_shape[axis % arr.dim()] = arr.shape[axis]
    i_shape = list(shape)
    i_shape[axis % arr.dim()] = indices.shape[axis]
    return torch.gather(arr.expand(a_shape), axis, indices.expand(i_shape))


@primitive("put_along_axis")
def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    arr, indices = as_t(arr), as_t(indices).to(torch.int64)
    values = as_t(values, arr).to(arr.dtype).expand(indices.shape)
    if reduce == "assign":
        return torch.scatter(arr, axis, indices, values)
    if reduce == "add":
        return torch.scatter_add(arr, axis, indices, values)
    if reduce == "multiply":
        return torch.scatter_reduce(arr, axis, indices, values, "prod")
    raise ValueError(f"Unknown reduce mode {reduce}")


@primitive("scatter")
def scatter(x, index, updates, overwrite=True, name=None):
    x, index = as_t(x), as_t(index).reshape(-1).to(torch.int64)
    updates = as_t(updates, x).to(x.dtype)
    if overwrite:
        return torch.index_put(x, (index,), updates)
    zeroed = torch.index_put(x, (index,), torch.zeros_like(updates))
    return torch.index_put(zeroed, (index,), updates, accumulate=True)


@primitive("scatter_nd_add")
def scatter_nd_add(x, index, updates, name=None):
    x, index = as_t(x), as_t(index).to(torch.int64)
    idx = tuple(torch.movedim(index, -1, 0))
    return torch.index_put(x, idx, as_t(updates, x).to(x.dtype),
                           accumulate=True)


@entry
def scatter_nd(index, updates, shape, name=None):
    u = as_t(updates)
    base = torch.zeros(shape_of(shape), dtype=u.dtype, device=u.device)
    return scatter_nd_add(base, index, u)


@primitive("index_select")
def index_select(x, index, axis=0, name=None):
    x, index = as_t(x), as_t(index).to(torch.int64)
    if index.dim() == 1:
        return torch.index_select(x, axis, index)
    flat = torch.index_select(x, axis, index.reshape(-1))
    ax = axis % x.dim()
    return flat.reshape(*x.shape[:ax], *index.shape, *x.shape[ax + 1:])


@primitive("index_sample")
def index_sample(x, index):
    return take_along_axis(x, index, axis=1)


@primitive("roll")
def roll(x, shifts, axis=None, name=None):
    x = as_t(x)
    if axis is None:
        return torch.roll(x, shifts)
    return torch.roll(x, shifts, axis)


@primitive("flip")
def flip(x, axis, name=None):
    x = as_t(x)
    dims = [axis] if isinstance(axis, int) else list(axis)
    return torch.flip(x, dims)


@entry
def rot90(x, k=1, axes=(0, 1), name=None):
    return _rot90(x, k=k, axes=tuple(axes))


@primitive("rot90")
def _rot90(x, k, axes):
    return torch.rot90(as_t(x), k, list(axes))


_PAD_MODES = {"constant": "constant", "reflect": "reflect",
              "replicate": "replicate", "circular": "circular"}


@primitive("pad_nd")
def pad(x, pad, mode="constant", value=0.0, data_format=None, name=None):
    x = as_t(x)
    pad = [int(p) for p in pad]
    if len(pad) == 2 * x.dim():
        cfg = [(pad[2 * i], pad[2 * i + 1]) for i in range(x.dim())]
    else:
        n_spatial = len(pad) // 2
        pairs = [(pad[2 * i], pad[2 * i + 1]) for i in range(n_spatial)]
        channel_last = data_format in ("NHWC", "NLC", "NDHWC")
        cfg = [(0, 0)] * x.dim()
        spatial = list(range(1, 1 + n_spatial)) if channel_last \
            else list(range(x.dim() - n_spatial, x.dim()))
        for i, dim in enumerate(reversed(spatial)):
            cfg[dim] = pairs[i]
    if mode == "constant":
        flat = [v for lo_hi in reversed(cfg) for v in lo_hi]
        return torch.nn.functional.pad(x, flat, value=value)
    # torch pads only trailing dims in these modes: move padded dims last
    dims = [d for d, c in enumerate(cfg) if c != (0, 0)]
    rest = [d for d in range(x.dim()) if d not in dims]
    y = x.permute(*rest, *dims)
    flat = [v for d in reversed(dims) for v in cfg[d]]
    lead = len(rest)
    y = y.reshape(1, -1, *y.shape[lead:]) if lead else y[None, None]
    out = torch.nn.functional.pad(y, flat, mode=_PAD_MODES[mode])
    out = out.reshape(*[x.shape[d] for d in rest], *out.shape[2:])
    inv = np.argsort(rest + dims).tolist()
    return out.permute(*inv)


@primitive("shard_index")
def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    x = as_t(input)
    size = (index_num + nshards - 1) // nshards
    in_shard = torch.div(x, size, rounding_mode="floor") == shard_id
    return torch.where(in_shard, torch.remainder(x, size),
                       torch.full_like(x, ignore_value))


@primitive("repeat_interleave")
def repeat_interleave(x, repeats, axis=None, name=None):
    x = as_t(x)
    if isinstance(repeats, (list, tuple, np.ndarray)):
        repeats = torch.as_tensor(np.asarray(repeats), device=x.device)
    if axis is None:
        return torch.repeat_interleave(x.reshape(-1), repeats)
    return torch.repeat_interleave(x, repeats, dim=axis)


@primitive("moveaxis")
def moveaxis(x, source, destination, name=None):
    return torch.movedim(as_t(x), source, destination)


@primitive("swapaxes")
def swapaxes(x, axis1, axis2, name=None):
    return torch.swapaxes(as_t(x), axis1, axis2)


@primitive("as_real")
def as_real(x, name=None):
    x = as_t(x)
    return torch.stack([x.real, x.imag], dim=-1)


@primitive("as_complex")
def as_complex(x, name=None):
    x = as_t(x)
    return torch.complex(x[..., 0], x[..., 1])


@primitive("real")
def real(x, name=None):
    x = as_t(x)
    return x.real if x.is_complex() else x


@primitive("imag")
def imag(x, name=None):
    x = as_t(x)
    return x.imag if x.is_complex() else torch.zeros_like(x)


# -- shapes that depend on the values ----------------------------------------
@entry
def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype=np.int64, name=None):
    x = as_t(x)
    flat = x.reshape(-1) if axis is None else x
    out, inverse, counts = torch.unique(
        flat, sorted=True, return_inverse=True, return_counts=True,
        dim=axis)
    res = [out]
    idt = dtype_mod.to_torch(dtype)
    if return_index:
        n = flat.shape[0 if axis is None else axis]
        pos = torch.arange(n, device=x.device)
        first = torch.full((out.shape[0 if axis is None else axis],), n,
                           dtype=torch.int64, device=x.device)
        first = first.scatter_reduce(0, inverse, pos, "amin")
        res.append(first.to(idt))
    if return_inverse:
        res.append(inverse.to(idt))
    if return_counts:
        res.append(counts.to(idt))
    return res[0] if len(res) == 1 else tuple(res)


@entry
def nonzero(x, as_tuple=False, name=None):
    nz = torch.nonzero(as_t(x))
    if as_tuple:
        return tuple(nz[:, i:i + 1] for i in range(nz.shape[1]))
    return nz


@entry
def masked_select(x, mask, name=None):
    return torch.masked_select(as_t(x), as_t(mask).to(torch.bool))


@primitive("masked_fill")
def masked_fill(x, mask, value, name=None):
    x = as_t(x)
    v = value.to(x.dtype) if isinstance(value, torch.Tensor) else \
        torch.tensor(value, dtype=x.dtype, device=x.device)
    return torch.where(as_t(mask).to(torch.bool), v, x)


@primitive("where")
def where(condition, x=None, y=None, name=None):
    c = as_t(condition)
    if x is None and y is None:
        return torch.where(c)
    x, y = pair(x, y)
    if x.dtype != y.dtype:
        dt = torch.promote_types(x.dtype, y.dtype)
        x, y = x.to(dt), y.to(dt)
    return torch.where(c.to(torch.bool), x, y)


@primitive("select_scatter")
def select_scatter(x, values, axis, index, name=None):
    x = as_t(x)
    return torch.select_scatter(x, as_t(values, x).to(x.dtype), axis, index)


@primitive("diagonal")
def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(as_t(x), offset, axis1, axis2)


@primitive("unfold")
def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    x = as_t(x)
    if isinstance(kernel_sizes, int):
        kernel_sizes = [kernel_sizes, kernel_sizes]
    if isinstance(strides, int):
        strides = [strides, strides]
    if isinstance(paddings, int):
        paddings = [paddings] * 4
    elif len(paddings) == 2:
        paddings = [paddings[0], paddings[1], paddings[0], paddings[1]]
    if isinstance(dilations, int):
        dilations = [dilations, dilations]
    x = torch.nn.functional.pad(x, (paddings[1], paddings[3], paddings[0],
                                    paddings[2]))
    return torch.nn.functional.unfold(x, tuple(kernel_sizes),
                                      dilation=tuple(dilations),
                                      stride=tuple(strides))


@entry
def tensordot(x, y, axes=2, name=None):
    return _tensordot(x, y, axes=axes)


@primitive("tensordot")
def _tensordot(x, y, axes):
    x, y = pair(x, y)
    if isinstance(axes, (list, tuple)):
        axes = [list(a) if isinstance(a, (list, tuple)) else [a]
                for a in axes]
    return torch.tensordot(x, y, dims=axes)


@primitive("crop")
def crop(x, shape=None, offsets=None, name=None):
    x = as_t(x)
    offsets = offsets or [0] * x.dim()
    idx = tuple(builtins.slice(int(o), int(o) + int(s))
                for o, s in zip(offsets, shape))
    return x[idx]


@entry
def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype=np.int64, name=None):
    x = as_t(x)
    flat = x.reshape(-1) if axis is None else x
    out, inverse, counts = torch.unique_consecutive(
        flat, return_inverse=True, return_counts=True, dim=axis)
    idt = dtype_mod.to_torch(dtype)
    res = [out]
    if return_inverse:
        res.append(inverse.to(idt))
    if return_counts:
        res.append(counts.to(idt))
    return res[0] if len(res) == 1 else tuple(res)


@primitive("as_strided", nondiff=("shape", "stride", "offset"))
def as_strided(x, shape, stride, offset=0, name=None):
    x = as_t(x).reshape(-1)
    shape = tuple(int(s) for s in shape)
    stride = tuple(int(s) for s in stride)
    idx = torch.tensor(int(offset), device=x.device)
    for s, st in zip(shape, stride):
        idx = idx[..., None] + torch.arange(s, device=x.device) * st
    return torch.take(x, idx.reshape(-1)).reshape(shape)


@entry
def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    return _view_dtype(x, dtype=dtype_mod.to_torch(shape_or_dtype))


@primitive("view_dtype")
def _view_dtype(x, dtype):
    x = as_t(x)
    src, dst = x.element_size(), torch.empty((), dtype=dtype).element_size()
    if dst > src and x.shape[-1] % (dst // src):
        raise ValueError(
            f"view: last dim {x.shape[-1]} not divisible by the "
            f"{x.dtype}->{dtype} size ratio {dst // src}")
    return x.contiguous().view(dtype)


@entry
def view_as(x, other, name=None):
    return reshape(x, tuple(as_t(other).shape))


@primitive("reverse", nondiff=("axis",))
def reverse(x, axis, name=None):
    if isinstance(axis, int):
        axis = [axis]
    return torch.flip(as_t(x), list(axis))


@entry
def shape(x, name=None):
    x = as_t(x)
    return torch.tensor(list(x.shape), dtype=torch.int32, device=x.device)


@entry
def size(x, name=None):
    x = as_t(x)
    return torch.tensor(x.numel(), dtype=torch.int64, device=x.device)


@entry
def rank(x, name=None):
    x = as_t(x)
    return torch.tensor(x.dim(), dtype=torch.int32, device=x.device)


@primitive("space_to_depth", nondiff=("blocksize",))
def space_to_depth(x, blocksize, name=None):
    x = as_t(x)
    n, c, h, w = x.shape
    bs = int(blocksize)
    x = x.reshape(n, c, h // bs, bs, w // bs, bs)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * bs * bs, h // bs, w // bs)


@primitive("shuffle_channel", nondiff=("group",))
def shuffle_channel(x, group, name=None):
    x = as_t(x)
    n, c, h, w = x.shape
    g = int(group)
    return x.reshape(n, g, c // g, h, w).permute(0, 2, 1, 3, 4) \
        .reshape(n, c, h, w)


@primitive("pad_constant_like")
def pad_constant_like(x, y, pad_value=0.0, name=None):
    x, y = as_t(x), as_t(y)
    flat = []
    for sx, sy in reversed(list(zip(x.shape, y.shape))):
        flat += [0, int(sx) - int(sy)]
    return torch.nn.functional.pad(y, flat, value=pad_value)


@entry
def crop_tensor(x, shape=None, offsets=None, name=None):
    return crop(x, shape if shape is not None else tuple(as_t(x).shape),
                offsets)


@entry
def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0,
                                  name=None):
    x = as_t(input)
    shape = list(shape)
    shape[output_dim_idx] = x.shape[input_dim_idx]
    return torch.full(tuple(int(s) for s in shape), value,
                      dtype=dtype_mod.to_torch(dtype), device=x.device)


@entry
def unique_with_counts(x, dtype=np.int64, name=None):
    x = as_t(x).reshape(-1)
    out, inv, cnt = torch.unique(x, sorted=True, return_inverse=True,
                                 return_counts=True)
    idt = dtype_mod.to_torch(dtype)
    return out, inv.to(idt), cnt.to(idt)
