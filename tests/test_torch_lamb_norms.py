"""A model of dygraph Lamb's norms as the card's phase 1 takes them
(``paddle_tpu_torch/ops/cuda/csrc/fused_optimizer.cu``
``lamb_phase1_pieces_kernel`` + ``segment_sum_kernel``), run on the
CPU: every parameter cut into pieces by ``fused_optimizer.lamb_pieces``
(the table the wrapper builds), each piece's sums of p*p and r*r taken
in f32, then each parameter's pieces added in f64 in the warp's fixed
order and rounded to f32. Held three ways:

- against ``torch._foreach_norm`` (the plain version's norms) of the
  same tensors in f64 within rtol 1e-6 (in f32 on the CPU that norm is
  itself 1.25e-5 off at a million elements: it sums in f32);
- the pieces cover every element exactly once, each inside one tensor
  and starting at a multiple of the piece size of it, including tensors
  smaller than a piece, empty ones and one that ends on a piece
  boundary;
- one Lamb step through the model's norms (the plain phase 1 and apply
  around them) against JAX's ``Lamb``, within the tolerances of
  ``tests/test_torch_optim.py``'s Lamb steps (p rtol 1e-5, m and v
  rtol 1e-6).

The kernels themselves run on the card only (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optimizer as jopt
from paddle_tpu.ops.pallas import counters as jcounters
from paddle_tpu_torch.ops.cuda import counters
from paddle_tpu_torch.ops.cuda import fused_optimizer as tfo

PIECE = tfo.LAMB_PIECE


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    """Run pallas_call in interpret mode so the JAX kernels run on CPU."""
    from jax.experimental import pallas as pl

    real = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(real, interpret=True))
    counters.reset()
    yield
    counters.reset()


LANES = 32         # a warp a tensor (segment_sum_kernel<32>)


def warp_sum(part):
    """A tensor's (m, 2) f64 piece sums added as the warp adds them:
    lane l takes pieces l, l + 32, ... in order, then a shuffle-down
    tree (lane l adds lane l + o's value, o = 16, 8, 4, 2, 1)."""
    lanes = [torch.zeros(2, dtype=torch.float64) for _ in range(LANES)]
    for k in range(part.shape[0]):
        lanes[k % LANES] = lanes[k % LANES] + part[k]
    o = LANES // 2
    while o:
        lanes = [lanes[i] + lanes[i + o] if i + o < LANES else lanes[i]
                 for i in range(LANES)]
        o //= 2
    return lanes[0]


def model_sums(params, rs, piece=PIECE):
    """(n, 2) f32: each tensor's sum of p*p and of r*r, pieces in f32,
    pieces of a tensor added in a fixed order in f64 (:func:`warp_sum`)."""
    numels = [p.numel() for p in params]
    pieces, first = tfo.lamb_pieces(numels, piece)
    flat = [torch.cat([x.reshape(-1) for x in xs]) if sum(numels) else
            torch.zeros(0) for xs in (params, rs)]
    part = torch.stack([torch.stack([(x[a:a + n] * x[a:a + n]).sum()
                                     for x in flat])
                        for a, n, _ in pieces.tolist()]) if len(pieces) \
        else torch.zeros(0, 2)
    part = part.to(torch.float64)
    return torch.stack([warp_sum(part[first[t]:first[t + 1]])
                        for t in range(len(params))]).to(torch.float32)


def model_norms(params, rs, piece=PIECE):
    """(2n,) f32 as ``_plain_lamb_apply_`` takes them: |p|..., |r|..."""
    return torch.sqrt(model_sums(params, rs, piece)).t().reshape(-1)


_SHAPES = [(100, 300), (64,), (0,), (3,), (2 * PIECE,), (PIECE + 1,),
           (7, 5), (PIECE,), (3 * PIECE - 4,)]


def _tensors(shapes, seed, scale=0.05):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy((rng.randn(*s) * scale).astype(np.float32))
            for s in shapes]


def test_model_norms_hold_to_foreach_norm():
    """Every tensor's |p| and |r| within rtol 1e-6 of torch's norm of
    its f64 copy (a million-element tensor of 123 pieces included); a
    zero tensor and an empty one have norm 0."""
    shapes = _SHAPES + [(1000, 1000)]
    ps = _tensors(shapes, 0)
    rs = _tensors(shapes, 1, scale=3.0)
    ps[1].zero_()
    got = model_norms(ps, rs)
    want = torch.stack(torch._foreach_norm([x.double() for x in ps + rs]))
    torch.testing.assert_close(got, want.float(), rtol=1e-6, atol=0.0)
    n = len(shapes)
    assert float(got[1]) == 0.0 and float(got[2]) == 0.0
    assert float(got[n + 2]) == 0.0


@pytest.mark.parametrize("piece", [PIECE, 4, 7, 64])
def test_pieces_cover_every_element_once(piece):
    """Each piece lies inside one tensor, starts at a multiple of the
    piece size of it and holds at most ``piece`` elements; the pieces
    are in order, cover the concatenation once, and ``tensor_first``
    gives each tensor's rows (none for an empty tensor)."""
    numels = [int(np.prod(s)) for s in _SHAPES] + [piece, 1, 0]
    ends = np.cumsum(numels)
    starts = ends - np.asarray(numels)
    pieces, first = tfo.lamb_pieces(numels, piece)
    assert pieces.dtype == first.dtype == np.int64
    assert first.shape == (len(numels) + 1,)
    assert first[0] == 0 and first[-1] == len(pieces)
    seen = np.zeros(int(ends[-1]), np.int64)
    for row, (a, n, t) in enumerate(pieces.tolist()):
        assert first[t] <= row < first[t + 1]
        assert 1 <= n <= piece
        assert starts[t] <= a and a + n <= ends[t]
        assert (a - starts[t]) % piece == 0
        seen[a:a + n] += 1
    assert (seen == 1).all()
    assert (pieces[1:, 0] == pieces[:-1, 0] + pieces[:-1, 1]).all()
    for t, n in enumerate(numels):
        assert first[t + 1] - first[t] == -(-n // piece)


def test_pieces_of_empty_and_single_lists():
    pieces, first = tfo.lamb_pieces([0, 0])
    assert pieces.shape == (0, 3) and first.tolist() == [0, 0, 0]
    pieces, first = tfo.lamb_pieces([2 * PIECE])
    assert pieces.tolist() == [[0, PIECE, 0], [PIECE, PIECE, 0]]
    assert first.tolist() == [0, 2]


def test_lamb_step_through_model_norms_matches_the_jax_optimizer(
        monkeypatch):
    """One Lamb step: the plain phase 1, the model's norms, the plain
    apply; against ``apply_gradients_fn`` with the Pallas kernel in
    interpret mode (p rtol 1e-5, m and v rtol 1e-6, as
    ``test_lamb_steps_match_the_jax_optimizer``). A zero bias moves by
    exactly lr * r (trust 1)."""
    monkeypatch.setenv("PADDLE_FUSED_OPT_INTERPRET", "1")
    rng = np.random.RandomState(31)
    shapes = {"w": (40, 300), "b": (64,), "e": (2 * PIECE,),
              "s": (7, 5)}
    ps = {k: rng.randn(*s).astype(np.float32) * 0.05
          for k, s in shapes.items()}
    ps["b"][:] = 0.0
    gs = {k: rng.randn(*s).astype(np.float32) * 0.01
          for k, s in shapes.items()}
    lr, b1, b2, eps, wd = 1e-3, 0.9, 0.999, 1e-6, 0.01
    jo = jopt.Lamb(learning_rate=lr, lamb_weight_decay=wd, parameters=[])
    jp = {k: jnp.asarray(x) for k, x in ps.items()}
    state = jo.init_state(jp)
    before = jcounters.snapshot()
    jp, state = jo.apply_gradients_fn(
        {k: jnp.asarray(x) for k, x in gs.items()}, jp, state, lr)
    assert jcounters.delta(before).get("fused_opt.pallas", 0) >= 1

    names = list(shapes)
    tp = [torch.from_numpy(ps[k].copy()) for k in names]
    tg = [torch.from_numpy(gs[k]) for k in names]
    tm = [torch.zeros_like(x) for x in tp]
    tv = [torch.zeros_like(x) for x in tp]
    tr = [torch.empty_like(x) for x in tp]
    lr32, c1, c2, _ = tfo.adam_scalars(lr, b1, b2, 1)
    tfo._plain_lamb_phase1_(tp, tg, tm, tv, tr, b1, b2, eps, wd, c1, c2)
    norms = model_norms(tp, tr)
    r_bias = tr[1].clone()
    tfo._plain_lamb_apply_(tp, tr, norms, lr32)
    for i, k in enumerate(names):
        slots = state["slots"][k]
        for got, want, rtol in ((tp[i], jp[k], 1e-5),
                                (tm[i], slots["moment1"], 1e-6),
                                (tv[i], slots["moment2"], 1e-6)):
            want = np.asarray(want)
            np.testing.assert_allclose(
                got.numpy(), want, rtol=rtol,
                atol=rtol * max(np.abs(want).max(), 1e-30))
    np.testing.assert_array_equal(tp[1].numpy(),
                                  (-np.float32(lr) * r_bias).numpy())
    assert counters.snapshot() == {}
