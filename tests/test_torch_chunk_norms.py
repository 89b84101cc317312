"""A model of K3's ZeRO chunk Lamb as the card's phase 1 takes its norms
(``paddle_tpu_torch/ops/cuda/csrc/fused_optimizer.cu``
``chunk_lamb_phase1_kernel``), run on the CPU: the chunk cut into pieces
by ``fused_optimizer.chunk_pieces`` (the table the wrapper builds, at the
piece size ``chunk_piece`` picks for the chunk), each piece's sums of p*p
and r*r taken in f32, then each segment's pieces added in f64 in the
order of the block that draws the last ticket (a warp a segment: lane l
takes pieces l, l + 32, ... in order, then a shuffle-down tree) and
rounded to f32. Held four ways:

- the pieces cover every element of the chunk once, each inside one
  segment and at most ``chunk_piece(c)`` long, at both ranks' positions
  of the book net's bucket over {"dp": 2} (the main path's chunk), at a
  one-segment chunk (BERT-base's word embedding) and at 64 segments;
- ``chunk_piece`` spreads a small chunk over many pieces and streams a
  large one 8192 elements at a time;
- the model's norms against the f64 norms of each segment within rtol
  1e-6 (the f32 piece sums are the only f32 rounding before the f64
  adds);
- one step through the model's norms (the plain phase 1 and update
  around them) against JAX's ``fused_chunk_update`` with the Pallas
  kernel in interpret mode, within ``tests/test_torch_chunk_optim.py``'s
  tolerances (m and v atol 1e-7 + rtol 1e-6; p atol 1e-6: the norms sum
  in another order than XLA's ``segment_sum``).

The kernels themselves run on the card only (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import counters as jcounters
from paddle_tpu.ops.pallas import fused_optimizer as jfo
from paddle_tpu_torch import static
from paddle_tpu_torch.ops.cuda import counters
from paddle_tpu_torch.ops.cuda import fused_optimizer as tfo
from paddle_tpu_torch.parallel.collectives import padded_len
from paddle_tpu_torch.static.passes import comm_bucket_plan
from paddle_tpu_torch.utils import unique_name

from _torch_zero_ranks import book_net

LANES = 32         # a warp a segment in the ticket block
G = 2              # the main path's {"dp": 2}


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl

    real = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(real, interpret=True))
    monkeypatch.setenv("PADDLE_FUSED_OPT_INTERPRET", "1")
    counters.reset()
    yield
    assert counters.snapshot() == {}                  # the CPU runs plain


def _book_layout():
    """The book net's one bucket over {"dp": 2}: parameter sizes in
    bucket order and the chunk length (``chip_smoke.book_bucket_layout``)."""
    main = book_net(static, unique_name, "lamb")[0]
    (b,) = comm_bucket_plan(main.global_block, ("int8", 4 << 20, False), G)
    sizes = tuple(int(np.prod(main.global_block.vars[g].shape))
                  for g in b["grads"])
    return sizes, padded_len(b["elems"], G) // G


def _layouts():
    book, c = _book_layout()
    word = padded_len(30522 * 768, G) // G
    # rank r owns chunk (r + 1) % g: rank 0 the tail, rank 1 the head
    return {"book_rank0": (book, c, c), "book_rank1": (book, c, 0),
            "bert_word_emb": ((30522 * 768,), word, word),
            "segments64": ((8192,) * 64, 524288, 0)}


LAYOUTS = _layouts()


def warp_sum(part):
    """A segment's (m, 2) f64 piece sums added as the ticket block's
    warp adds them: lane l takes pieces l, l + 32, ... in order, then a
    shuffle-down tree (lane l adds lane l + o's value, o = 16, ..., 1)."""
    lanes = [torch.zeros(2, dtype=torch.float64) for _ in range(LANES)]
    for k in range(part.shape[0]):
        lanes[k % LANES] = lanes[k % LANES] + part[k]
    o = LANES // 2
    while o:
        lanes = [lanes[i] + lanes[i + o] if i + o < LANES else lanes[i]
                 for i in range(LANES)]
        o //= 2
    return lanes[0]


def model_seg_sums(p, r, elems, pos):
    """(n_params + 1, 2) f32: each segment's sums of p*p and r*r, pieces
    in f32, a segment's pieces added in f64 in the ticket block's order
    (:func:`warp_sum`); a segment with no piece sums to 0."""
    pieces, seg_first = tfo.chunk_pieces(elems, pos, p.numel())
    part = torch.stack([torch.stack([(x[a:a + n] * x[a:a + n]).sum()
                                     for x in (p, r)])
                        for a, n, _ in pieces.tolist()]).to(torch.float64)
    return torch.stack([warp_sum(part[seg_first[s]:seg_first[s + 1]])
                        for s in range(len(elems) + 1)]).to(torch.float32)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_pieces_cover_the_chunk_once_inside_segments(layout):
    """Pieces tile [0, c) in order, each inside one segment and at most
    ``chunk_piece(c)`` long; ``seg_first`` gives each segment's rows (the
    ticket block's warp s reads rows seg_first[s]:seg_first[s + 1])."""
    elems, c, pos = LAYOUTS[layout]
    piece = tfo.chunk_piece(c)
    pieces, seg_first = tfo.chunk_pieces(elems, pos, c)
    seg = tfo.chunk_segments(elems, pos, c)
    seen = np.zeros(c, np.int64)
    for row, (a, n, s) in enumerate(pieces.tolist()):
        assert 1 <= n <= piece
        assert (seg[a:a + n] == s).all()
        assert seg_first[s] <= row < seg_first[s + 1]
        seen[a:a + n] += 1
    assert (seen == 1).all()
    assert seg_first.shape == (len(elems) + 2,)
    assert seg_first[0] == 0 and seg_first[-1] == len(pieces)


@pytest.mark.parametrize("c,piece", [(1, 512), (9216, 512),
                                     (135168, 512), (135169, 1024),
                                     (524288, 2048), (1 << 21, 8192),
                                     (11720704, 8192)])
def test_piece_size_follows_the_chunk(c, piece):
    """The least power of two from 512 to 8192 that cuts the chunk into
    at most CHUNK_SPREAD (264) runs."""
    assert tfo.chunk_piece(c) == piece
    assert tfo.chunk_pieces((c,), 0, c)[0][:, 1].max() <= piece


def test_book_chunk_spreads_over_many_pieces():
    """The main path's chunk (9,216 elements, 6 parameters and the
    padding) is cut into about 20 pieces, not the 5-6 a 4096-element
    cut gave."""
    for name in ("book_rank0", "book_rank1"):
        elems, c, pos = LAYOUTS[name]
        assert c == 9216 and sum(elems) == 18378
        assert len(tfo.chunk_pieces(elems, pos, c)[0]) >= 18


@pytest.mark.parametrize("layout", ["book_rank0", "book_rank1",
                                    "segments64", "bert_word_emb"])
def test_model_norms_hold_to_f64_norms(layout):
    """Each segment's |p| and |r| within rtol 1e-6 of the f64 norm of
    the same f32 values; the padding's sentinel segment of zeros is 0."""
    elems, c, pos = LAYOUTS[layout]
    rng = np.random.RandomState(5)
    p = torch.from_numpy(rng.randn(c).astype(np.float32) * 0.05)
    r = torch.from_numpy(rng.randn(c).astype(np.float32) * 3.0)
    seg = torch.from_numpy(tfo.chunk_segments(elems, pos, c))
    tail = seg == len(elems)
    p[tail] = 0.0
    r[tail] = 0.0
    got = torch.sqrt(model_seg_sums(p, r, elems, pos))
    want = torch.stack([
        torch.zeros(len(elems) + 1, dtype=torch.float64).index_add_(
            0, seg, x.double() * x.double()) for x in (p, r)], 1).sqrt()
    torch.testing.assert_close(got, want.float(), rtol=1e-6, atol=0.0)
    assert (got[-1] == 0).all()


@pytest.mark.parametrize("found", [None, False, True],
                         ids=["absent", "false", "true"])
@pytest.mark.parametrize("layout", ["book_rank0", "book_rank1"])
def test_step_through_model_norms_matches_fused_chunk_update(layout, found):
    """One chunk Lamb step: the plain phase 1, the model's segment sums
    in place of the plain version's, the plain update; against
    ``fused_chunk_update`` in interpret mode, ``axis=None``."""
    elems, c, pos = LAYOUTS[layout]
    rng = np.random.RandomState(c + 3)
    f32 = np.float32
    ins = {"Param": rng.randn(c).astype(f32) * f32(0.5),
           "Grad": rng.randn(c).astype(f32) * f32(0.1),
           "Moment1": rng.randn(c).astype(f32) * f32(0.01),
           "Moment2": np.abs(rng.randn(c)).astype(f32) * f32(1e-3),
           "LearningRate": np.array([0.05], f32),
           "Beta1Pow": np.array([0.9 ** 3], f32),
           "Beta2Pow": np.array([0.999 ** 3], f32)}
    tail = min(c, max(0, pos + c - sum(elems)))
    for k in ("Param", "Grad", "Moment1", "Moment2"):
        ins[k][c - tail:] = 0.0
    if found is not None:
        ins["FoundInfinite"] = np.array([found])
    attrs = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
             "weight_decay": 0.01}
    before = jcounters.snapshot()
    want = jfo.fused_chunk_update(
        "lamb", {k: [jnp.asarray(v)] for k, v in ins.items()}, attrs,
        axis=None, param_elems=elems, position=pos)
    assert jcounters.delta(before).get("fused_opt.pallas", 0) == 1

    t = {k: torch.tensor(v) for k, v in ins.items()}
    p, g, m, v = t["Param"], t["Grad"], t["Moment1"], t["Moment2"]
    seg = torch.from_numpy(tfo.chunk_segments(elems, pos, c))
    norms = {}

    def reduce(sq):           # the model's sums where the plain version's
        m_new, v_new = tfo._static_moments(g, m, v, 0.9, 0.999)
        c1, c2 = t["Beta1Pow"] * 0.9, t["Beta2Pow"] * 0.999
        r = (m_new / (1 - c1)) / (torch.sqrt(v_new / (1 - c2)) + 1e-6) \
            + 0.01 * p
        norms["model"] = model_seg_sums(p, r, elems, pos)
        sq.copy_(norms["model"])

    pows = tfo._plain_chunk_lamb_(p, g, m, v, t["Beta1Pow"], t["Beta2Pow"],
                                  t["LearningRate"], 0.9, 0.999, 1e-6, 0.01,
                                  t.get("FoundInfinite"), seg,
                                  len(elems) + 1, reduce)
    assert norms["model"].shape == (len(elems) + 1, 2)
    for got, slot in ((m, "Moment1Out"), (v, "Moment2Out")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want[slot][0]),
                                   rtol=1e-6, atol=1e-7, err_msg=slot)
    np.testing.assert_allclose(p.numpy(), np.asarray(want["ParamOut"][0]),
                               rtol=0, atol=1e-6)
    for got, slot in zip(pows, ("Beta1PowOut", "Beta2PowOut")):
        np.testing.assert_array_equal(got.numpy().reshape(1),
                                      np.asarray(want[slot][0]).reshape(1))
    if found:
        np.testing.assert_array_equal(p.numpy(), ins["Param"])
