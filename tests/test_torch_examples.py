"""The repo's user scripts through the port with only their import
changed, on the CPU.

Each script's text runs with ``import paddle_tpu as paddle`` replaced by
``import paddle_tpu_torch as paddle`` plus a prelude of
``paddle.set_device("cpu")``, and ``from paddle_tpu...`` by ``from
paddle_tpu_torch...``; it must print ``OK`` (its own assertions hold).
``train_bert.py`` runs its ``BERT_SMOKE=1`` config (BERT tiny, 5 steps);
``translate_beam.py`` its own (d_model 64, head width 16: attention's
counted plain route) and ``train_wgan_gp.py`` its own (double gradient
through ``autograd.grad(create_graph=True)``).

The WGAN-GP parity case: the script's G and D in both packages, the
port's carried over from JAX's by ``load_numpy_state``, fed the same
numpy batches: the first 5 values of ``d_loss``, ``gp`` and ``g_loss``
agree within 1e-5 relative.
"""
import contextlib
import io
import pathlib
import re

import numpy as np
import pytest

from paddle_tpu_torch._device import set_default_device

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"


def port_text(name):
    """The script's text with only its import changed."""
    src = (EXAMPLES / name).read_text()
    src, n = re.subn(r"^import paddle_tpu as paddle$",
                     "import paddle_tpu_torch as paddle\n"
                     "paddle.set_device(\"cpu\")", src, flags=re.M)
    assert n == 1
    return re.sub(r"^from paddle_tpu([ .])", r"from paddle_tpu_torch\1",
                  src, flags=re.M)


@pytest.fixture
def cpu_default():
    yield
    set_default_device(None)


@pytest.mark.parametrize("name", ["train_bert.py", "train_wgan_gp.py",
                                  "translate_beam.py"])
def test_example_prints_ok_through_the_port(name, monkeypatch,
                                            cpu_default):
    monkeypatch.setenv("BERT_SMOKE", "1")
    out = io.StringIO()
    src = port_text(name)
    assert "paddle_tpu." not in src.replace("paddle_tpu_torch", "")
    with contextlib.redirect_stdout(out):
        exec(compile(src, name, "exec"), {"__name__": "__main__"})
    lines = out.getvalue().splitlines()
    assert lines[-1] == "OK", lines[-5:]
    if name == "train_bert.py":
        assert lines[0] == "device: cpu"


def _wgan_steps(P, nn, optimizer, autograd, G, D, batches, steps):
    g_opt = optimizer.Adam(learning_rate=1e-3, parameters=G.parameters())
    d_opt = optimizer.Adam(learning_rate=1e-3, parameters=D.parameters())
    rows = []
    for real_np, z1, eps_np, z2 in batches[:steps]:
        real = P.to_tensor(real_np)
        z = P.to_tensor(z1)
        fake = G(z).detach()
        eps = P.to_tensor(eps_np)
        inter = P.to_tensor(
            eps.numpy() * real.numpy() + (1 - eps.numpy()) * fake.numpy(),
            stop_gradient=False)
        d_inter = D(inter).sum()
        (grad_x,) = autograd.grad(d_inter, [inter], create_graph=True)
        gp = (((grad_x * grad_x).sum(axis=1) + 1e-12).sqrt() - 1.0)
        gp = (gp * gp).mean() * 10.0
        d_loss = D(fake).mean() - D(real).mean() + gp
        d_loss.backward()
        d_opt.step()
        d_opt.clear_grad()
        g_loss = -D(G(P.to_tensor(z2))).mean()
        g_loss.backward()
        g_opt.step()
        g_opt.clear_grad()
        rows.append([float(d_loss.numpy()), float(gp.numpy()),
                     float(g_loss.numpy())])
    return np.array(rows)


def test_wgan_gp_first_steps_match_jax(cpu_default):
    import paddle_tpu as jp
    import paddle_tpu_torch as tp
    from paddle_tpu import autograd as jag, nn as jnn, optimizer as jopt
    from paddle_tpu_torch import autograd as tag, nn as tnn, optimizer as topt
    from paddle_tpu_torch.nn.layer import load_numpy_state

    tp.set_device("cpu")
    rng = np.random.RandomState(0)
    batches = []
    for _ in range(5):
        c = rng.randint(0, 2, (64, 1)).astype(np.float32)
        real = rng.randn(64, 2).astype(np.float32) * 0.2 + \
            np.concatenate([c * 2 - 1, 1 - c * 2], 1)
        batches.append((real, rng.randn(64, 4).astype(np.float32),
                        rng.rand(64, 1).astype(np.float32),
                        rng.randn(64, 4).astype(np.float32)))

    def nets(nn):
        return (nn.Sequential(nn.Linear(4, 32), nn.ReLU(), nn.Linear(32, 2)),
                nn.Sequential(nn.Linear(2, 32), nn.ReLU(), nn.Linear(32, 1)))

    jp.seed(0)
    JG, JD = nets(jnn)
    TG, TD = nets(tnn)
    for j, t in ((JG, TG), (JD, TD)):
        load_numpy_state(t, {k: np.array(v.numpy())
                             for k, v in j.state_dict().items()})
    want = _wgan_steps(jp, jnn, jopt, jag, JG, JD, batches, 5)
    got = _wgan_steps(tp, tnn, topt, tag, TG, TD, batches, 5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
