"""Static-graph optimizers: append_backward + one update op per parameter.

Port of ``paddle_tpu/static/optimizer.py``: ``minimize`` appends the
backward op, the regularization ops, a persistable learning-rate
variable and, per parameter, its accumulators (startup
``fill_constant`` ops) and its update op, with the JAX package's op
slots, attrs and accumulator names (``{param}_{optimizer}_{suffix}``).
The update ops run K3's static forms (``static/kernels.py``).

Not in this slice: ``grad_clip`` and ``set_gradient_clip``, and a
learning rate given as a graph-built schedule Variable.
"""
from __future__ import annotations

from ..utils import unique_name
from .backward import append_backward
from .ir import VarDesc, Variable
from .layers import LayerHelper, _append_simple

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "Lamb", "SGDOptimizer",
           "MomentumOptimizer", "AdamOptimizer", "LambOptimizer",
           "OPTIMIZER_OP_TYPES", "set_gradient_clip"]

OPTIMIZER_OP_TYPES = {"sgd", "momentum", "adam", "lamb", "increment"}


def _no_clip():
    raise NotImplementedError(
        "gradient clipping on a static optimizer is not in this port "
        "slice; a later port slice adds it")


def set_gradient_clip(clip, param_list=None, program=None):
    """Program-level default gradient clip: not in this slice."""
    _no_clip()


class Optimizer:
    def __init__(self, learning_rate=0.001, regularization=None,
                 grad_clip=None, name=None):
        if grad_clip is not None:
            _no_clip()
        if isinstance(learning_rate, Variable):
            raise NotImplementedError(
                "a graph-built learning-rate schedule is not in this port "
                "slice; a later port slice adds it")
        self.learning_rate = learning_rate
        self.regularization = regularization
        self.grad_clip = None
        self._name = name or type(self).__name__.lower()
        self._lr_var = None

    # -- helpers ----------------------------------------------------------
    def _create_lr_var(self, helper: LayerHelper):
        # the cached lr var is only valid within its own program
        if self._lr_var is not None and \
                self._lr_var.block.program is helper.main_program:
            return self._lr_var
        name = unique_name.generate(f"{self._name}_lr")
        self._lr_var = self._create_persist(
            helper, name, (1,), float(self.learning_rate))
        return self._lr_var

    @staticmethod
    def _create_persist(helper, name, shape, value, dtype="float32"):
        desc = VarDesc(name, shape, dtype, persistable=True)
        helper.main_program.global_block.vars[name] = desc
        sb = helper.startup_program.global_block
        sb.vars[name] = VarDesc(name, shape, dtype, persistable=True)
        sb.append_op(type="fill_constant", inputs={},
                     outputs={"Out": [name]},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "value": float(value)})
        return Variable(helper.main_program.global_block, desc)

    def _accumulator(self, helper, param, suffix, value=0.0, shape=None):
        name = f"{param.name}_{self._name}_{suffix}"
        return self._create_persist(
            helper, name, shape or param.shape, value, param.dtype)

    # -- public API -------------------------------------------------------
    def minimize(self, loss: Variable, startup_program=None,
                 parameter_list=None, no_grad_set=None):
        params_grads = append_backward(loss, parameter_list, no_grad_set)
        self.apply_gradients(params_grads)
        return [], params_grads

    def apply_gradients(self, params_grads):
        helper = LayerHelper(self._name)
        params_grads = self._append_regularization_ops(params_grads)
        lr = self._create_lr_var(helper)
        for p, g in params_grads:
            self._append_update(helper, p, g, lr)
        return []

    def _append_regularization_ops(self, params_grads):
        """Weight decay as ops: L2 adds scale(p)·coeff to the grad, L1
        adds scale(sign(p))·coeff."""
        if self.regularization is None:
            return params_grads
        from ..regularizer import L1Decay

        reg = self.regularization
        out = []
        for p, g in params_grads:
            src = _append_simple("sign", {"X": [p]}) \
                if isinstance(reg, L1Decay) else p
            decay = _append_simple("scale", {"X": [src]},
                                   {"scale": float(reg.coeff)})
            g2 = _append_simple("elementwise_add", {"X": [g], "Y": [decay]})
            out.append((p, g2))
        return out

    def _append_update(self, helper, p, g, lr):
        raise NotImplementedError


class SGD(Optimizer):
    def _append_update(self, helper, p, g, lr):
        helper.block.append_op(
            type="sgd",
            inputs={"Param": [p], "Grad": [g], "LearningRate": [lr]},
            outputs={"ParamOut": [p.name]})


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9,
                 use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self.momentum = momentum
        self.use_nesterov = use_nesterov

    def _append_update(self, helper, p, g, lr):
        vel = self._accumulator(helper, p, "velocity")
        helper.block.append_op(
            type="momentum",
            inputs={"Param": [p], "Grad": [g], "Velocity": [vel],
                    "LearningRate": [lr]},
            outputs={"ParamOut": [p.name], "VelocityOut": [vel.name]},
            attrs={"mu": self.momentum, "use_nesterov": self.use_nesterov})


class _AdamLike(Optimizer):
    """Adam's and Lamb's op wiring: two moments and one beta-pow pair
    per parameter."""
    _op = None

    def _attrs(self):
        raise NotImplementedError

    def _append_update(self, helper, p, g, lr):
        m1 = self._accumulator(helper, p, "moment1")
        m2 = self._accumulator(helper, p, "moment2")
        b1p = self._accumulator(helper, p, "beta1pow", 1.0, (1,))
        b2p = self._accumulator(helper, p, "beta2pow", 1.0, (1,))
        helper.block.append_op(
            type=self._op,
            inputs={"Param": [p], "Grad": [g], "Moment1": [m1],
                    "Moment2": [m2], "Beta1Pow": [b1p], "Beta2Pow": [b2p],
                    "LearningRate": [lr]},
            outputs={"ParamOut": [p.name], "Moment1Out": [m1.name],
                     "Moment2Out": [m2.name], "Beta1PowOut": [b1p.name],
                     "Beta2PowOut": [b2p.name]},
            attrs=self._attrs())


class Adam(_AdamLike):
    _op = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _attrs(self):
        return {"beta1": self.beta1, "beta2": self.beta2,
                "epsilon": self.epsilon}


class Lamb(_AdamLike):
    _op = "lamb"

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self.wd = lamb_weight_decay
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _attrs(self):
        return {"beta1": self.beta1, "beta2": self.beta2,
                "epsilon": self.epsilon, "weight_decay": self.wd}


SGDOptimizer = SGD
MomentumOptimizer = Momentum
AdamOptimizer = Adam
LambOptimizer = Lamb
