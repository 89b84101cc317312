"""paddle_tpu_torch.static — the declarative (static-graph) mode.

Port of ``paddle_tpu/static``, cut to the first path through it:
``examples/train_resnet_static.py``'s network trained by ``SGD``,
``Momentum``, ``Adam`` or ``Lamb``. The Program/Block/Op IR and its JSON
are the JAX package's (``ir.py``); layers build the same programs under
the same names (``layers.py``); ``append_backward`` emits the same
backward op (``backward.py``); the Executor interprets a block op by op
on the card, gradients from autograd, the update ops through K3's static
CUDA forms (``executor.py``, ``kernels.py``); inference models and
programs are saved and loaded in the JAX package's files (``io.py``).

    import paddle_tpu_torch.static as static
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        x = static.data("x", [-1, 784])
        label = static.data("label", [-1, 1], dtype="int64")
        h = static.nn.fc(x, 128, act="relu")
        logits = static.nn.fc(h, 10)
        loss = static.mean(
            static.softmax_with_cross_entropy(logits, label))
        static.Adam(1e-3).minimize(loss)
    exe = static.Executor()          # the card; CPUPlace() for the CPU
    exe.run(startup)
    out, = exe.run(main, feed={"x": ..., "label": ...},
                   fetch_list=[loss])

Data-parallel over g ranks (one process each, joined by
``distributed.init_parallel_env`` and ``parallel.create_mesh({"dp": g})``;
every rank feeds the global batch): ``bs = static.BuildStrategy();
bs.mesh_shape = {"dp": g}`` (+ ``comm_quant``, ``zero_stage``) and
``exe.run(static.CompiledProgram(main, build_strategy=bs), ...)``
(``compiler.py``, ``stepplan.py``).
"""
from . import initializer  # noqa: F401
from .backward import append_backward  # noqa: F401
from .compiler import (BuildStrategy, CompiledProgram,  # noqa: F401
                       ExecutionStrategy)
from .executor import (Executor, Scope, global_scope,  # noqa: F401
                       load_numpy_state, op_runs, scope_guard)
from .io import (load_inference_model, load_params,  # noqa: F401
                 load_persistables, load_program, save_inference_model,
                 save_params, save_persistables, save_program)
from .ir import (Block, OpDesc, Program, VarDesc, Variable,  # noqa: F401
                 default_main_program, default_startup_program,
                 program_guard)
from .layers import *  # noqa: F401,F403
from .layers import data  # noqa: F401
from .optimizer import (SGD, Adam, AdamOptimizer, Lamb,  # noqa: F401
                        LambOptimizer, Momentum, MomentumOptimizer,
                        Optimizer, SGDOptimizer, set_gradient_clip)
from ..framework.place import CPUPlace, CUDAPlace  # noqa: F401

from . import layers as nn  # noqa: F401  (static.nn.fc style access)
