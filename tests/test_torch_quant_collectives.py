"""The port's quantized ring collectives and bucket plan against the JAX
package on the CPU (oracle: ``tests/test_quant_collectives.py``).

- The codec (``collectives.quant_encode`` / ``quant_decode``) against
  JAX's eager ``quant_encode`` / ``quant_decode``, bit for bit: random
  blocks, all-zero blocks (scale 0, exact zeros) and ties at .5 (half to
  even); int8, bf16 and f32.
- The closed forms (``padded_len``, ``encoded_nbytes``, ``ring_nbytes``,
  ``reduce_scatter_nbytes``, ``all_gather_nbytes``) equal JAX's.
- One 4-rank gloo spawn (``tests/_torch_zero_ranks.py``
  ``collectives_rank``) runs the ring: the all-reduce against JAX's
  ``quantized_allreduce`` on a 4-device mesh (bit for bit with the f32
  and bf16 codecs; int8 within one quantum of the scales, since XLA may
  compile the scale's division by 127 as a multiply); ``reduce_scatter``
  owning chunk ``(idx + 1) % g`` and, in f32, equal to the ring's sum in
  its own order bit for bit; ``avg`` dividing by g; the raw-f32
  ``ring_all_gather`` exact; ``ring_all_gather(reduce_scatter(x))`` the
  all-reduce bit for bit.
- ``comm_bucket_plan`` equal to JAX's on the same programs, bucket for
  bucket; ``resolve_comm`` / ``resolve_zero`` / ``resolve_sharding`` as
  JAX resolves the same strategies.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.static as js
from paddle_tpu.parallel import collectives as JC
from paddle_tpu.parallel.mesh import mesh_for_shape
from paddle_tpu.static import passes as jpasses
from paddle_tpu.utils import unique_name as jun
import paddle_tpu_torch.static as ts
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.parallel import collectives as TC
from paddle_tpu_torch.static import passes as tpasses
from paddle_tpu_torch.utils import unique_name as tun

import _torch_zero_ranks as ranks

G = 4
CODECS = ("f32", "bf16", "int8")


def _vector(kind, n=2048, seed=1):
    rng = np.random.RandomState(seed)
    v = (rng.randn(n) * 3).astype(np.float32)
    if kind == "zero_blocks":
        v[:512] = 0.0
        v[1024:1536] = 0.0
    elif kind == "ties":
        # amax 127 makes the scale exactly 1: x/scale is x, so the .5
        # values are ties, rounded half to even
        v = np.tile(np.array([127.0, 2.5, 3.5, -0.5, -1.5, 0.5, 126.5,
                              -126.5], np.float32), n // 8)
    elif kind == "tiny":
        v = v * np.float32(1e-30)
    return v


@pytest.mark.parametrize("kind", ["random", "zero_blocks", "ties", "tiny"])
@pytest.mark.parametrize("codec", CODECS)
def test_codec_matches_jax_bit_for_bit(codec, kind):
    v = _vector(kind)
    jq, jsc = JC.quant_encode(jnp.asarray(v), codec)
    tq, tsc = TC.quant_encode(torch.from_numpy(v), codec)
    if codec == "bf16":
        np.testing.assert_array_equal(
            tq.view(torch.int16).numpy(),
            np.asarray(jq).view(np.int16))
    else:
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert (tsc is None) == (jsc is None)
    if tsc is not None:
        np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    np.testing.assert_array_equal(
        TC.quant_decode(tq, tsc, codec).numpy(),
        np.asarray(JC.quant_decode(jq, jsc, codec)))
    if kind == "zero_blocks" and codec == "int8":
        assert (tsc.numpy()[[0, 2]] == 0).all()
        assert (TC.quant_decode(tq, tsc, codec).numpy()[:512] == 0).all()
    if kind == "ties" and codec == "int8":
        assert list(tq.numpy()[:8]) == [127, 2, 4, 0, -2, 0, 126, -126]


@pytest.mark.parametrize("n", [1, 777, 1000, 4096, 18378, 11720704 + 3])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
def test_closed_forms_match_jax(n, g):
    assert TC.padded_len(n, g) == JC.padded_len(n, g)
    for codec in CODECS:
        assert TC.encoded_nbytes(n, codec) == JC.encoded_nbytes(n, codec)
        assert TC.ring_nbytes(n, g, codec) == JC.ring_nbytes(n, g, codec)
        rs = TC.reduce_scatter_nbytes(n, g, codec)
        ag = TC.all_gather_nbytes(n, g, codec)
        assert rs == JC.reduce_scatter_nbytes(n, g, codec)
        assert ag == JC.all_gather_nbytes(n, g, codec)
        assert rs + ag == TC.ring_nbytes(n, g, codec)


# (name, op, per-rank contributions, kwargs)
def _cases():
    rng = np.random.RandomState(2)
    cases = []
    for n in (1000, 777):
        x = (rng.randn(G, n) * 3).astype(np.float32)
        for codec in CODECS:
            for avg in (False, True):
                cases.append((f"ar_{codec}_{n}_{avg}", "allreduce", x,
                              {"start": {"codec": codec},
                               "done": {"avg": avg}}))
            cases.append((f"rsag_{codec}_{n}", "rs_ag", x,
                          {"codec": codec}))
    x = rng.randn(G, TC.padded_len(4096, G)).astype(np.float32)
    cases.append(("rs_f32", "reduce_scatter", x, {"codec": "f32"}))
    cases.append(("rs_f32_avg", "reduce_scatter", x,
                  {"codec": "f32", "avg": True}))
    cases.append(("rs_int8", "reduce_scatter", x, {"codec": "int8"}))
    chunks = rng.randn(G, 512).astype(np.float32)
    cases.append(("ag_f32", "ring_all_gather", chunks, {}))
    return cases


CASES = _cases()
BY_NAME = {c[0]: c for c in CASES}


@pytest.fixture(scope="module")
def ring4(tmp_path_factory):
    path = tmp_path_factory.mktemp("ring4") / "rendezvous"
    return spawn(ranks.collectives_rank, args=(G, CASES), nprocs=G,
                 init_method=f"file://{path}", timeout=180)


@pytest.fixture(scope="module")
def mesh4():
    return mesh_for_shape({"dp": G})


def test_ranks_are_the_mesh_rows(ring4):
    assert [r["coords"] for r in ring4] == [{"dp": i} for i in range(G)]
    for r in ring4:        # the CPU ring stages nothing, launches nothing
        assert r["launches"] == {}


@pytest.mark.parametrize("name", [c[0] for c in CASES
                                  if c[1] == "allreduce"])
def test_ring_allreduce_matches_jax(ring4, mesh4, name):
    _, _, x, kw = BY_NAME[name]
    codec, avg = kw["start"]["codec"], kw["done"]["avg"]
    want = np.asarray(JC.quantized_allreduce(jnp.asarray(x), mesh4, "dp",
                                             codec=codec, avg=avg))
    exact = x.astype(np.float64).sum(0) / (G if avg else 1)
    for r in ring4:
        got = r[name]
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, ring4[0][name])
        if codec == "int8":
            # one quantum of the largest scale, the scales themselves
            # may differ in the last bit
            q = np.abs(x).max() * G / 127 / (G if avg else 1)
            np.testing.assert_allclose(got, want, rtol=0, atol=1.01 * q)
            assert np.abs(got - exact).max() / np.abs(exact).max() <= 3e-2
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", [c[0] for c in CASES if c[1] == "rs_ag"])
def test_reduce_scatter_then_gather_is_the_allreduce(ring4, name):
    _, _, x, kw = BY_NAME[name]
    ar = f"ar_{kw['codec']}_{x.shape[1]}_False"
    for r in ring4:
        np.testing.assert_array_equal(r[name][:x.shape[1]], r[ar])


def test_reduce_scatter_owns_the_next_chunk_in_f32_ring_order(ring4):
    x = BY_NAME["rs_f32"][2]
    chunks = x.reshape(G, G, -1)        # [rank, chunk, elems]
    for idx, r in enumerate(ring4):
        own = (idx + 1) % G
        acc = np.zeros_like(chunks[0, 0])
        for t in range(1, G):
            acc = acc + chunks[(idx + t) % G, own]
        acc = acc + chunks[idx, own]
        np.testing.assert_array_equal(r["rs_f32"], acc)
        np.testing.assert_array_equal(r["rs_f32_avg"],
                                      r["rs_f32"] / np.float32(G))
        assert np.abs(r["rs_int8"] - acc).max() <= 3e-2 * np.abs(acc).max()


def test_ring_all_gather_raw_f32_is_exact(ring4):
    chunks = BY_NAME["ag_f32"][2]
    want = np.concatenate([chunks[(pos - 1) % G] for pos in range(G)])
    for r in ring4:
        np.testing.assert_array_equal(r["ag_f32"], want)


def _train_program(static, un, hidden=(32, 16)):
    """``tests/test_quant_collectives.py``'s ``_train_program``."""
    with un.guard():
        main, startup = static.Program(), static.Program()
        main.random_seed = startup.random_seed = 77
        with static.program_guard(main, startup):
            x = static.data("x", [-1, 16])
            label = static.data("label", [-1, 1], dtype="int64")
            h = x
            for w in hidden:
                h = static.nn.fc(h, w, act="relu")
            logits = static.nn.fc(h, 4)
            loss = static.mean(
                static.softmax_with_cross_entropy(logits, label))
            static.SGD(0.05).minimize(loss)
    return main


PROGRAMS = {
    "train_program": lambda s, u: _train_program(s, u),
    "dp_net": lambda s, u: ranks.dp_net(s, u, "adam")[0],
    "book_net": lambda s, u: ranks.book_net(s, u, "lamb")[0],
}


@pytest.mark.parametrize("bucket_bytes", [1024, 8192, 1 << 20, 4 << 20])
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("prog", list(PROGRAMS))
def test_bucket_plan_matches_jax(prog, codec, bucket_bytes):
    comm = (codec, bucket_bytes, False)
    want = jpasses.comm_bucket_plan(
        PROGRAMS[prog](js, jun).global_block, comm, G)
    got = tpasses.comm_bucket_plan(
        PROGRAMS[prog](ts, tun).global_block, comm, G)
    assert got == want
    assert len(got) >= 1


def test_book_net_is_one_bucket_of_18378():
    plan = tpasses.comm_bucket_plan(
        PROGRAMS["book_net"](ts, tun).global_block, ("int8", 4 << 20, False),
        2)
    assert [b["elems"] for b in plan] == [18378]
    assert TC.padded_len(18378, 2) == 18432


@pytest.mark.parametrize("fields", [
    {}, {"comm_quant": "int8"}, {"comm_quant": "BF16"},
    {"comm_quant": "f32", "comm_bucket_bytes": 1024,
     "comm_error_feedback": True},
    {"comm_quant": "off", "zero_stage": 2}, {"zero_stage": 3},
    {"mesh_shape": {"dp": 4}}, {"mesh_shape": {"dp": 1, "data": 2}},
    {"mesh_shape": {"dp": 2, "tp": 2}}])
def test_resolvers_match_jax(fields, monkeypatch):
    for k in ("PADDLE_IR_PASSES", "PADDLE_QUANT_ALLREDUCE", "PADDLE_ZERO"):
        monkeypatch.delenv(k, raising=False)
    jb, tb = js.BuildStrategy(), ts.BuildStrategy()
    for k, v in fields.items():
        setattr(jb, k, v)
        setattr(tb, k, v)
    assert tpasses.resolve_comm(tb) == jpasses.resolve_comm(jb)
    assert tpasses.resolve_zero(tb) == jpasses.resolve_zero(jb)
    assert tpasses.resolve_sharding(tb) == jpasses.resolve_sharding(jb)
    cfg = tpasses.resolve_sharding(tb)
    assert tpasses.comm_data_axis(cfg) == jpasses.comm_data_axis(cfg)


def test_resolvers_raise_as_jax_does():
    for mod, static in ((tpasses, ts), (jpasses, js)):
        bs = static.BuildStrategy()
        bs.comm_quant = "fp8"
        with pytest.raises(ValueError, match="comm_quant"):
            mod.resolve_comm(bs)
        bs = static.BuildStrategy()
        bs.zero_stage = 1
        with pytest.raises(ValueError, match="zero_stage"):
            mod.resolve_zero(bs)
