"""Runtime settings of the process (counterpart of
``etmppo_tpu/utils/runtime.py``, which sets JAX's compilation cache).

``resolve_device`` chooses the device and decides float32 precision: it
turns TF32 off for matmuls and for cuDNN's convolutions. PyTorch leaves
``torch.backends.cudnn.allow_tf32`` on by default, so without this the card
would run the CNN's convolutions in TF32 while the parity tests hold
float32. The flags are process-wide, so they are set whatever the device
(harmless on the CPU, where a test can see them).

Every entry point goes through it: ``PPOTrainer.__init__`` (training and
``cli.py``) and ``training/checkpoint.load_model``, which ``PolicyServer``,
``serve_http``, ``Evaluation`` through ``evaluate_model`` /
``evaluate_protocol``, and ``enjoy.run_episodes`` call. No other module of
the package sets either flag. Under data parallelism every rank's
``PPOTrainer`` calls it with the rank's device (``parallel/mesh.make_mesh``:
``cuda:<LOCAL_RANK>`` under NCCL, the named card under gloo), so each
process sets its own flags.

``compute_dtype`` reads a config's ``compute_dtype``: the dtype the model
computes in (``torch.bfloat16`` runs it as flax's ``dtype=bfloat16`` does,
``models/``); the parameters stay float32 either way.

``set_debug_nans`` is the counterpart of ``jax_debug_nans`` (``cli.py
--debug-nans``): while it is on, the first NaN or infinity raises
``FloatingPointError``, naming where it appeared: a module's forward output
(a global forward hook), a function of the backward (autograd's anomaly
mode, whose error ``nan_errors`` turns into ``FloatingPointError``), or a
parameter after an optimizer step (a global step hook). Each check syncs
with the device. Off (the default), no hook is registered and anomaly mode
is off: nothing is added to the hot path.
"""
from __future__ import annotations

import contextlib
import weakref

import torch

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device) -> torch.device:
    """The device to run on, with float32 precision set; raises rather than
    fall back to the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(--cpu) to run on the CPU")
    return device


def compute_dtype(config) -> torch.dtype:
    """The dtype ``config.compute_dtype`` names: float32 or bfloat16."""
    name = config.compute_dtype
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of "
                         f"{sorted(COMPUTE_DTYPES)}, got {name!r}")
    return COMPUTE_DTYPES[name]


# --- --debug-nans ------------------------------------------------------------

_handles: list = []
_module_names: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
# Tensors compare elementwise, so parameters are keyed by id, with a weak
# reference that tells a reused id apart.
_param_names: dict = {}


def debug_nans_enabled() -> bool:
    return bool(_handles)


def name_modules(model: torch.nn.Module) -> None:
    """Lets the checks name ``model``'s modules and parameters by their
    qualified names under the model's class (else by their class or
    shape)."""
    root = type(model).__name__
    for name, module in model.named_modules():
        _module_names[module] = f"{root}.{name}" if name else root
    for name, param in model.named_parameters():
        _param_names[id(param)] = (weakref.ref(param), f"{root}.{name}")


def _non_finite(t) -> bool:
    return (isinstance(t, torch.Tensor) and t.is_floating_point()
            and not bool(torch.isfinite(t).all()))


def _flat(outputs):
    if isinstance(outputs, (tuple, list)):
        for x in outputs:
            yield from _flat(x)
    else:
        yield outputs


def _check_forward(module, inputs, outputs) -> None:
    del inputs
    if any(_non_finite(t) for t in _flat(outputs)):
        name = _module_names.get(module, type(module).__name__)
        raise FloatingPointError(
            f"debug-nans: a NaN or infinity in the forward output of {name}")


def _check_step(optimizer, args, kwargs) -> None:
    del args, kwargs
    for group in optimizer.param_groups:
        for p in group["params"]:
            if _non_finite(p):
                ref, name = _param_names.get(id(p), (None, None))
                if ref is None or ref() is not p:
                    name = f"a parameter of shape {tuple(p.shape)}"
                raise FloatingPointError(
                    f"debug-nans: {name} holds a NaN or infinity after the "
                    f"optimizer step (learning rate {group['lr']})")


def set_debug_nans(enabled: bool) -> None:
    """Turns the NaN checks on or off, for every model and optimizer of the
    process (as ``jax_debug_nans`` is process-wide)."""
    from torch.optim.optimizer import register_optimizer_step_post_hook
    while _handles:
        _handles.pop().remove()
    if not enabled:
        _module_names.clear()
        _param_names.clear()
    torch.autograd.set_detect_anomaly(enabled, check_nan=True)
    if enabled:
        _handles.append(torch.nn.modules.module.register_module_forward_hook(
            _check_forward))
        _handles.append(register_optimizer_step_post_hook(_check_step))


@contextlib.contextmanager
def nan_errors():
    """Where the checks are on, anomaly mode's error for a NaN that a
    backward function returned is raised as ``FloatingPointError``."""
    try:
        yield
    except RuntimeError as e:
        if debug_nans_enabled() and "returned nan values" in str(e):
            raise FloatingPointError(f"debug-nans: {e}") from e
        raise
