"""Framework core of the port (``paddle_tpu/framework``): ``Tensor`` and
its operators (``tensor``, ``math_op_patch``), grad mode (``tape``), the
op bridge (``op``), dtypes, places and the default device, flags,
errors, execution mode and the random state."""
from . import dtype, errors, flags, mode, place, random
from .dtype import (bool_, uint8, int8, int16, int32, int64,  # noqa: F401
                    float16, bfloat16, float32, float64, complex64,
                    complex128, convert_dtype, set_default_dtype,
                    get_default_dtype)
from .errors import (  # noqa: F401
    EnforceNotMet, InvalidArgumentError, NotFoundError, OutOfRangeError,
    AlreadyExistsError, ResourceExhaustedError, PreconditionNotMetError,
    PermissionDeniedError, ExecutionTimeoutError, UnimplementedError,
    UnavailableError, FatalError, ExternalError, enforce)
from .flags import define_flag, get_flag, get_flags, set_flags  # noqa
from .place import (  # noqa: F401
    Place, CPUPlace, CUDAPlace, TPUPlace, XPUPlace, CUDAPinnedPlace,
    is_compiled_with_tpu, is_compiled_with_cuda, get_device, set_device,
    device_count, get_default_place)
from .random import seed, default_generator, rng_scope, Generator  # noqa
from .tape import no_grad, enable_grad, grad_enabled  # noqa: F401
from .tensor import Tensor, to_tensor, is_tensor  # noqa: F401
from .op import primitive, OP_REGISTRY  # noqa: F401


def __getattr__(name):
    if name == "LayerList":
        from ..nn import LayerList

        return LayerList
    raise AttributeError(
        f"module 'paddle_tpu_torch.framework' has no attribute {name!r}")
