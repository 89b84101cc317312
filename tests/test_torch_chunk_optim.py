"""K3's ZeRO chunk entry in the port against the JAX package on the CPU.

``ops/cuda/fused_optimizer.chunk_update`` (its Lamb, ``chunk_lamb_``,
runs its plain version ``_plain_chunk_lamb_`` on CPU tensors) against
``fused_chunk_update`` with the Pallas kernel forced into interpret mode,
``axis=None`` (the chunk's norms are its own). Buckets whose parameter
boundaries fall inside a chunk and on a chunk's edge, chunk positions 0
and non-zero, FoundInfinite absent, false and true. sgd, momentum and
adam chunks are the static forms, against ``fused_op_update`` on the
flat chunk. The segment ids and the piece table the CUDA kernels walk
are checked against ``_chunk_segments``.

Tolerances: m, v and the sgd, momentum and adam updates within atol
1e-7 + rtol 1e-6, as the static forms' tests (XLA's CPU backend may fuse
a product and a sum into one FMA where the port rounds each); Lamb's p
within atol 1e-6 (the squared norms also sum in another order than XLA's
``segment_sum``). Against the port's static Lamb on the same tensors
(one chunk that is one whole parameter) m is bit for bit.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import counters as jcounters
from paddle_tpu.ops.pallas import fused_optimizer as jfo
from paddle_tpu_torch.ops.cuda import counters
from paddle_tpu_torch.ops.cuda import fused_optimizer as tfo
from paddle_tpu_torch.parallel.collectives import padded_len

ATTRS = {"sgd": {}, "momentum": {"mu": 0.9, "use_nesterov": False},
         "nesterov": {"mu": 0.9, "use_nesterov": True},
         "adam": {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
         "lamb": {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
                  "weight_decay": 0.01}}
# bucket parameter sizes, chunk length c (the bucket padded over g = 2)
# and the chunk's position: boundaries inside the chunk, a boundary on
# the chunk's edge (2048), the padding tail, a one-segment chunk
LAYOUTS = {
    "inside_pos0": ((700, 1500, 300, 1000), 2048, 0),
    "inside_pos1": ((700, 1500, 300, 1000), 2048, 2048),
    "edge_pos0": ((2048, 1500), 2048, 0),
    "edge_pos1": ((2048, 1500), 2048, 2048),
    "one_param_pos1": ((3000,), 2048, 2048),
    "many_small_pos0": tuple([(64,) * 40, 2048, 0]),
}
FOUND = {"absent": None, "false": False, "true": True}


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl

    real = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(real, interpret=True))
    monkeypatch.setenv("PADDLE_FUSED_OPT_INTERPRET", "1")
    counters.reset()
    yield
    counters.reset()


def _inputs(op, c, found, seed):
    rng = np.random.RandomState(seed)
    f32 = np.float32
    ins = {"Param": rng.randn(c).astype(f32) * f32(0.5),
           "Grad": rng.randn(c).astype(f32) * f32(0.1),
           "LearningRate": np.array([0.05], f32)}
    if op in ("momentum", "nesterov"):
        ins["Velocity"] = rng.randn(c).astype(f32) * f32(0.05)
    if op in ("adam", "lamb"):
        ins["Moment1"] = rng.randn(c).astype(f32) * f32(0.01)
        ins["Moment2"] = np.abs(rng.randn(c)).astype(f32) * f32(1e-3)
        ins["Beta1Pow"] = np.array([0.9 ** 3], f32)
        ins["Beta2Pow"] = np.array([0.999 ** 3], f32)
    if found is not None:
        ins["FoundInfinite"] = np.array([found])
    return ins


def _port(op, ins, layout=None):
    t = {k: [torch.tensor(v)] for k, v in ins.items()}
    jop = "momentum" if op == "nesterov" else op
    kw = {}
    if layout is not None:
        kw = {"param_elems": layout[0], "position": layout[2]}
    outs = tfo.chunk_update(jop, t, ATTRS[op], **kw)
    return {k: v[0].numpy() for k, v in outs.items()}


def _jax_ins(ins):
    return {k: [jnp.asarray(v)] for k, v in ins.items()}


def _padding_zeroed(ins, layout):
    """The bucket's padding tail holds zeros in p, g, m and v, as the
    ZeRO step's concatenation makes it."""
    elems, c, pos = layout
    tail = min(c, max(0, pos + c - sum(elems)))
    if tail:
        for k in ("Param", "Grad", "Moment1", "Moment2"):
            ins[k][c - tail:] = 0.0
    return ins


@pytest.mark.parametrize("found", list(FOUND))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_chunk_lamb_plain_matches_fused_chunk_update(layout, found):
    lay = LAYOUTS[layout]
    c = lay[1]
    ins = _padding_zeroed(_inputs("lamb", c, FOUND[found], seed=c + 7), lay)
    before = jcounters.snapshot()
    want = jfo.fused_chunk_update("lamb", _jax_ins(ins), ATTRS["lamb"],
                                  axis=None, param_elems=lay[0],
                                  position=lay[2])
    assert jcounters.delta(before).get("fused_opt.pallas", 0) == 1
    got = _port("lamb", ins, lay)
    assert set(got) == set(want)
    for slot in ("Moment1Out", "Moment2Out"):
        np.testing.assert_allclose(got[slot], np.asarray(want[slot][0]),
                                   rtol=1e-6, atol=1e-7, err_msg=slot)
    for slot in ("Beta1PowOut", "Beta2PowOut"):
        assert got[slot].shape == (1,)
        np.testing.assert_array_equal(got[slot],
                                      np.asarray(want[slot][0]).reshape(1))
    np.testing.assert_allclose(got["ParamOut"],
                               np.asarray(want["ParamOut"][0]), rtol=0,
                               atol=1e-6)
    if found == "true":
        np.testing.assert_array_equal(got["ParamOut"], ins["Param"])
    assert counters.snapshot() == {}                # the CPU runs plain


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_segments_match_jax(layout):
    elems, c, pos = LAYOUTS[layout]
    want = np.asarray(jfo._chunk_segments(elems, pos, c))
    np.testing.assert_array_equal(tfo.chunk_segments(elems, pos, c), want)


@pytest.mark.parametrize("layout", list(LAYOUTS) + ["bert_word_emb"])
def test_piece_table_covers_the_chunk_in_segment_runs(layout):
    """Pieces tile [0, c) in order, each inside one segment and at most
    chunk_piece(c) long (the piece size follows the chunk, at most
    CHUNK_PIECE); seg_first indexes each segment's run of pieces."""
    if layout == "bert_word_emb":
        elems = (30522 * 768,)
        c = padded_len(30522 * 768, 2) // 2
        pos = c                    # rank 0 owns chunk 1, with the padding
    else:
        elems, c, pos = LAYOUTS[layout]
    pieces, seg_first = tfo.chunk_pieces(elems, pos, c)
    starts, lens, segs = pieces.T
    assert starts[0] == 0 and (starts[1:] == starts[:-1] + lens[:-1]).all()
    assert starts[-1] + lens[-1] == c
    assert tfo.chunk_piece(c) <= tfo.CHUNK_PIECE
    assert (lens > 0).all() and (lens <= tfo.chunk_piece(c)).all()
    seg = tfo.chunk_segments(elems, pos, c)
    assert (seg[starts] == segs).all() and (seg[starts + lens - 1] == segs
                                            ).all()
    assert seg_first.shape == (len(elems) + 2,)
    for s in range(len(elems) + 1):
        assert (segs[seg_first[s]:seg_first[s + 1]] == s).all()
    assert seg_first[-1] == len(pieces)


@pytest.mark.parametrize("found", list(FOUND))
@pytest.mark.parametrize("op", ["sgd", "momentum", "nesterov", "adam"])
def test_elementwise_chunks_match_fused_op_update(op, found):
    """sgd, momentum and adam chunks are fused_chunk_update's delegate,
    fused_op_update, on the flat chunk."""
    jop = "momentum" if op == "nesterov" else op
    ins = _inputs(op, 2048, FOUND[found], seed=11)
    want = jfo.fused_chunk_update(jop, _jax_ins(ins), ATTRS[op], axis=None,
                                  param_elems=(1000, 1048), position=0)
    got = _port(op, ins, ((1000, 1048), 2048, 0))
    assert set(got) == set(want)
    for slot, w in want.items():
        w = np.asarray(w[0]).reshape(got[slot].shape)
        np.testing.assert_allclose(got[slot], w, rtol=1e-6, atol=1e-7,
                                   err_msg=slot)


def test_one_chunk_of_one_param_is_the_static_lamb():
    """A chunk that is the whole of one parameter (no padding) takes the
    static Lamb's update: the same trust ratio from the same norms up to
    their summation order."""
    ins = _inputs("lamb", 4096, None, seed=3)
    got = _port("lamb", ins, ((4096,), 4096, 0))
    t = {k: torch.tensor(v) for k, v in ins.items()}
    tfo.static_lamb_(t["Param"], t["Grad"], t["Moment1"], t["Moment2"],
                     t["Beta1Pow"], t["Beta2Pow"], t["LearningRate"],
                     beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=0.01)
    np.testing.assert_array_equal(got["Moment1Out"], t["Moment1"].numpy())
    np.testing.assert_allclose(got["ParamOut"], t["Param"].numpy(), rtol=0,
                               atol=1e-6)


def test_chunk_lamb_raises_on_what_it_does_not_take():
    p = torch.zeros(8)
    one = torch.ones(1)
    with pytest.raises(ValueError, match="flat chunk"):
        tfo.chunk_lamb_(torch.zeros(2, 4), torch.zeros(2, 4),
                        torch.zeros(2, 4), torch.zeros(2, 4), one, one, one,
                        beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=0.0,
                        param_elems=(8,), position=0)
    with pytest.raises(ValueError, match="f32"):
        tfo.chunk_lamb_(p, p.double(), p, p, one, one, one, beta1=0.9,
                        beta2=0.999, eps=1e-6, weight_decay=0.0,
                        param_elems=(8,), position=0)
    with pytest.raises(NotImplementedError, match="chunk update"):
        tfo.chunk_update("adagrad", {"Param": [p], "Grad": [p],
                                     "LearningRate": [one]}, {})
