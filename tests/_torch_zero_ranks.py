"""Rank bodies and the two networks of the port's data-parallel static
tests (tests/test_torch_static_zero.py, tests/test_torch_quant_collectives.py).
They import torch and the port only: a rank never loads JAX. The
network functions take the ``static`` and ``unique_name`` modules of either
package, so the JAX oracle in the pytest process builds the same program
under the same names.
"""
import numpy as np
import torch

from paddle_tpu_torch.distributed import init_parallel_env
from paddle_tpu_torch.ops.cuda import counters

OPTS = {"sgd": lambda s: s.SGD(0.05),
        "momentum": lambda s: s.Momentum(0.05, momentum=0.9),
        "adam": lambda s: s.Adam(0.01),
        "lamb": lambda s: s.Lamb(0.01)}


def dp_net(static, un, opt, hidden=(64, 32), seed=77):
    """``tests/test_pipeline_zero.py``'s ``_dp_net``: fc layers on 16
    features, 4 classes; (main, startup, loss, [fetch extras])."""
    with un.guard():
        main, startup = static.Program(), static.Program()
        main.random_seed = startup.random_seed = seed
        with static.program_guard(main, startup):
            x = static.data("x", [-1, 16])
            label = static.data("label", [-1, 1], dtype="int64")
            h = x
            for w in hidden:
                h = static.nn.fc(h, w, act="relu")
            logits = static.nn.fc(h, 4)
            loss = static.mean(
                static.softmax_with_cross_entropy(logits, label))
            OPTS[opt](static).minimize(loss)
    return main, startup, loss, []


def book_net(static, un, opt):
    """The book's recognize_digits conv network (``tests/test_book.py:
    62-81``): conv 5x5x16 + relu, pool 2, conv 5x5x32 + relu, pool 2, fc
    10; softmax cross-entropy, mean, accuracy."""
    with un.guard():
        main, startup = static.Program(), static.Program()
        with static.program_guard(main, startup):
            img = static.data("img", [-1, 1, 28, 28])
            label = static.data("label", [-1, 1], dtype="int64")
            h = static.nn.conv2d(img, 16, 5, act="relu")
            h = static.nn.pool2d(h, 2, pool_stride=2)
            h = static.nn.conv2d(h, 32, 5, act="relu")
            h = static.nn.pool2d(h, 2, pool_stride=2)
            logits = static.nn.fc(h, 10)
            loss = static.mean(
                static.softmax_with_cross_entropy(logits, label))
            acc = static.accuracy(static.softmax(logits), label)
            OPTS[opt](static).minimize(loss)
    return main, startup, loss, [acc]


NETS = {"dp_net": dp_net, "book_net": book_net}


def target(static, main, loss, g, leg):
    """What a leg runs: the plain Program (``None``), a CompiledProgram
    over ``{"dp": g}`` with the leg's BuildStrategy fields (a dict), or
    ``"with_data_parallel"``: ``CompiledProgram(main).with_data_parallel()``
    with no ``mesh_shape`` (the mesh's data axis in the port, every
    device in JAX)."""
    if leg is None:
        return main
    if leg == "with_data_parallel":
        return static.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name)
    bs = static.BuildStrategy()
    bs.mesh_shape = {"dp": g}
    for k, v in leg.items():
        setattr(bs, k, v)
    return static.CompiledProgram(main, build_strategy=bs)


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else t


def run_legs(static, un, exe, scope, net, opt, feed, legs, steps, g,
             fetch_vel=False):
    """``steps`` steps per leg on one executor and a scope that holds
    the startup state: (losses, extra fetches). ``fetch_vel`` adds the
    first velocity to the fetches."""
    main, _startup, loss, extra = NETS[net](static, un, opt)
    fetch = [loss] + list(extra)
    if fetch_vel:
        fetch.append([op.inputs["Velocity"][0]
                      for op in main.global_block.ops
                      if op.type == "momentum"][0])
    losses, extras = [], []
    for leg in legs:
        prog = target(static, main, loss, g, leg)
        for _ in range(steps):
            out = exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)
            losses.append(float(np.ravel(out[0])[0]))
            extras.append([np.asarray(o) for o in out[1:]])
    return losses, extras


def zero_rank(n, cases, device="cpu"):
    """Every case on ``create_mesh({"dp": n})``: case = (name, net, opt,
    init, feed, legs, steps, fetch_vel). Per case: losses, extra fetches,
    the executor's counters, the launches and verdicts with their
    reasons, and the scope after the steps ({name: ndarray}, rows
    included). ``device="cuda"``: every rank on cuda:0."""
    import paddle_tpu_torch.static as ts
    from paddle_tpu_torch.parallel import create_mesh
    from paddle_tpu_torch.utils import unique_name as un

    torch.set_num_threads(1)
    place = ts.CPUPlace()
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        place = ts.CUDAPlace(0)
    init_parallel_env("gloo")
    mesh = create_mesh({"dp": n})
    got = {"coords": mesh.coords}
    for name, net, opt, init, feed, legs, steps, fetch_vel in cases:
        counters.reset()
        scope, exe = ts.Scope(), ts.Executor(place)
        ts.load_numpy_state(scope, init, place)
        try:
            losses, extras = run_legs(ts, un, exe, scope, net, opt, feed,
                                      legs, steps, n, fetch_vel)
        except Exception as e:      # reported, checked by the test
            got[name] = {"error": f"{type(e).__name__}: {e}"}
            continue
        snap = counters.snapshot()
        got[name] = {
            "losses": losses, "extras": extras,
            "counters": dict(exe.counters), "launches": snap,
            "reasons": {k: counters.reasons(k) for k in snap},
            "scope": {k: _np(v) for k, v in scope.items()
                      if torch.is_tensor(v)},
            "layout": scope.find_var("__zero_layout__") is not None}
    return got


def collectives_rank(n, cases):
    """The ring collectives on ``create_mesh({"dp": n})``. Each case is
    (name, op, x (n, ...) per-rank contributions, kwargs); returns
    {name: ndarray} of this rank's result."""
    from paddle_tpu_torch.parallel import collectives as C
    from paddle_tpu_torch.parallel import create_mesh

    torch.set_num_threads(1)
    init_parallel_env("gloo")
    mesh = create_mesh({"dp": n})
    r = mesh.axis_index("dp")
    got = {"coords": mesh.coords}
    counters.reset()
    for name, op, x, kw in cases:
        mine = torch.tensor(x[r])
        if op == "allreduce":
            out = C.allreduce_done(C.allreduce_start(mine, "dp", mesh=mesh,
                                                     **kw["start"]),
                                   **kw["done"])
        elif op == "reduce_scatter":
            out = C.reduce_scatter(mine, "dp", mesh=mesh, **kw)
        elif op == "rs_ag":
            out = C.ring_all_gather(
                C.reduce_scatter(mine, "dp", mesh=mesh, **kw), "dp",
                mesh=mesh, **kw)
        elif op == "ring_all_gather":
            out = C.ring_all_gather(mine, "dp", mesh=mesh, **kw)
        else:
            raise ValueError(op)
        got[name] = out.numpy()
    got["launches"] = counters.snapshot()
    return got
