"""The fused CDE vector field: trunk -> tanh head -> dX contraction.

PyTorch counterpart of ``fused_matmul_field`` in the JAX package's
``ops/kernels.py``.  Per RK stage a matmul-type Neural CDE computes

    u   = relu(... relu(z @ W_1 + b_1) ... @ W_n + b_n)
    A   = tanh(u @ W_o + b_o)                 # (B, I*H), never stored
    out = einsum('bih,bi->bh', A, dX)

On a CUDA tensor :func:`fused_matmul_field` launches the hand-written
Hopper kernel ``csrc/fused_field.cu`` (the port of the TPU kernel
``_forward_pallas``: the trunk pass of ``csrc/trunk_mma.cuh`` and a head
kernel, both on the tensor cores in 3xTF32, for H and HH up to 256; one
CUDA-core kernel above that); on a CPU tensor it runs the plain version
:func:`_forward_reference`, line for line the JAX package's
``_forward_reference``.  The choice follows the tensor's device only:
nothing falls back from the kernel to the plain version.  The forward is
the op ``oncde::fused_field_forward`` (:func:`fused_field_forward_op`):
its CUDA implementation launches the kernel, its CPU implementation is
the plain version and its fake implementation gives the output's shape,
so ``torch.export`` records the field as one node of an exported program
(``serving_export``).

Both kernels take float32 or bfloat16 storage (every operand of one
dtype) and the JAX op's ``precision``: ``"float32"`` multiplies the
operands as stored, ``"bfloat16"`` rounds each product's two operands to
bf16 first.  Every product accumulates in float32 (:func:`_mm`), the bias
add, relu, tanh and the dX sum stay float32, and only the results are
rounded to the storage dtype.

The gradient is a ``torch.autograd.Function`` whose backward is the same
kind of pair: on a CUDA tensor the Hopper kernel ``csrc/fused_field_bwd.cu``
(the port of ``_backward_pallas``), on a CPU tensor
:func:`_backward_reference`, autograd through the plain forward (what the
JAX package's default VJP computes).  The op records an autograd node only
when grad mode is on and an input requires grad, or under a
``torch.func`` transform; otherwise it is called directly.

Under ``torch.func.vmap`` (the training wave's K replicas,
``training/wave.py``) both Functions' ``vmap`` rules stack the replicas
and call :func:`fused_matmul_field_multi` / :func:`fused_field_backward_multi`,
the K-replica forms: on a CUDA tensor one call of the kernels' multi entry
points (``oncde_fused_field_forward_multi`` and
``oncde_fused_field_backward_multi``, the same launches as one replica's
with the replica along the grid, as Pallas's batching rule gives the TPU
kernel under ``jax.vmap``), on a CPU tensor the plain versions over the
stacked operands.  An operand every replica shares (dX, the weights when
they are not batched) keeps one copy, at replica stride 0.

The head is packed contraction-major, (HH, I*H), unpadded: the TPU's
128-lane padding is a layout rule of that chip and is not carried over.

:func:`fused_rk4_interval` and :func:`fused_rk4_interval_multi` are the
counterparts of the JAX ops of the same names: one whole RK4 (3/8) interval
of the fused field with a constant dX, for one model or for K stacked
replicas, in one launch of ``csrc/fused_rk4_interval.cu`` on a CUDA
tensor (a cluster kernel on the tensor cores for H and HH up to 256, a
CUDA-core kernel above; the library picks by shape); their plain versions
step ``solvers.tree_fixed_step("rk4")`` over :func:`_forward_reference`.
Both take float32 or bfloat16 storage and, as the JAX ops, step in float32
on widened operands and round only the result to the state's dtype.  Like
the JAX ops (bare ``pallas_call``s), they have no gradient.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from online_neural_cdes_tpu_torch.ops import solvers
from online_neural_cdes_tpu_torch.utils.cuda_build import CudaKernel

__all__ = ["fused_matmul_field", "fused_matmul_field_multi", "fused_field_backward_multi",
           "fused_field_forward_op", "pack_fused_params", "fused_rk4_interval",
           "fused_rk4_interval_multi", "fused_field_kernel", "fused_field_bwd_kernel", "fused_field_multi_kernel",
           "fused_field_bwd_multi_kernel", "fused_rk4_kernel", "fused_rk4_multi_kernel"]

MAX_TRUNK = 4

_PTRS = ctypes.POINTER(ctypes.c_void_p)

# The forward kernel's launcher (one count per call of its C entry point,
# which runs two launches in stream order, or one for H or HH above 256).
fused_field_kernel = CudaKernel(
    "fused_field.cu",
    "oncde_fused_field_forward",
    [ctypes.c_void_p, ctypes.c_void_p,                   # z, dx
     _PTRS, _PTRS, ctypes.c_int,                         # trunk w, b, n
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # head_w, head_b, out
     ctypes.c_void_p, ctypes.c_longlong,                 # scratch, its floats
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, H, HH, I
     ctypes.c_int, ctypes.c_int,                         # storage dtype, precision
     ctypes.c_void_p],                                   # stream
)

# The backward kernel's launcher (one count per call of its C entry point,
# which runs four launches in stream order).
fused_field_bwd_kernel = CudaKernel(
    "fused_field_bwd.cu",
    "oncde_fused_field_backward",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # z, dx, g
     _PTRS, _PTRS, ctypes.c_int,                         # trunk w, b, n
     ctypes.c_void_p, ctypes.c_void_p,                   # head_w, head_b
     ctypes.c_void_p, ctypes.c_void_p,                   # dz, ddx
     _PTRS, _PTRS,                                       # dtrunk w, b
     ctypes.c_void_p, ctypes.c_void_p,                   # dhead_w, dhead_b
     ctypes.c_void_p, ctypes.c_longlong,                 # scratch, its floats
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, H, HH, I
     ctypes.c_int, ctypes.c_int,                         # storage dtype, precision
     ctypes.c_void_p],                                   # stream
)

# The K-replica entry points of both field kernels (one count per call,
# which runs the single entry's launches once for all K replicas).  Each
# takes the replicas' input strides as a host array of _STRIDE_SLOTS
# elements: z, dx, g (backward only), head_w, head_b, then trunk w_0..w_3
# and b_0..b_3.
_STRIDE_SLOTS = 5 + 2 * MAX_TRUNK
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
fused_field_multi_kernel = CudaKernel(
    "fused_field.cu",
    "oncde_fused_field_forward_multi",
    [ctypes.c_void_p, ctypes.c_void_p,                   # z, dx
     _PTRS, _PTRS, ctypes.c_int,                         # trunk w, b, n
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # head_w, head_b, out
     ctypes.c_void_p, ctypes.c_longlong,                 # scratch, its floats
     ctypes.c_int, _STRIDES,                             # K, input strides
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, H, HH, I
     ctypes.c_int, ctypes.c_int,                         # storage dtype, precision
     ctypes.c_void_p],                                   # stream
)
fused_field_bwd_multi_kernel = CudaKernel(
    "fused_field_bwd.cu",
    "oncde_fused_field_backward_multi",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # z, dx, g
     _PTRS, _PTRS, ctypes.c_int,                         # trunk w, b, n
     ctypes.c_void_p, ctypes.c_void_p,                   # head_w, head_b
     ctypes.c_void_p, ctypes.c_void_p,                   # dz, ddx
     _PTRS, _PTRS,                                       # dtrunk w, b
     ctypes.c_void_p, ctypes.c_void_p,                   # dhead_w, dhead_b
     ctypes.c_void_p, ctypes.c_longlong,                 # scratch, its floats
     ctypes.c_int, _STRIDES,                             # K, input strides
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, H, HH, I
     ctypes.c_int, ctypes.c_int,                         # storage dtype, precision
     ctypes.c_void_p],                                   # stream
)

# The field kernels' codes for the storage dtype and the precision.
STORAGE = (torch.float32, torch.bfloat16)
PRECISIONS = ("float32", "bfloat16")

# The whole-interval RK4 kernel's two entry points (one library).
_RK4_HEAD = [ctypes.c_void_p, ctypes.c_void_p, _PTRS, _PTRS, ctypes.c_int,  # z, dx, trunk
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]    # head_w, head_b, out
_DIMS = [ctypes.c_int] * 4                                         # B, H, HH, I
_RK4_TAIL = [ctypes.c_int, ctypes.c_void_p]                   # storage dtype, stream
fused_rk4_kernel = CudaKernel("fused_rk4_interval.cu", "oncde_fused_rk4_interval",
                              _RK4_HEAD + _DIMS + _RK4_TAIL)
fused_rk4_multi_kernel = CudaKernel(
    "fused_rk4_interval.cu", "oncde_fused_rk4_interval_multi",
    _RK4_HEAD + [ctypes.c_int] + _DIMS + _RK4_TAIL)            # ..., K, B, H, HH, I, ...


def pack_fused_params(field_params, hidden_dim: int, input_dim: int) -> dict:
    """Re-layout an 'original' VectorField's parameters for the fused op:
    the head weight (HH, H*I) becomes contraction-major (HH, I*H) and the
    head bias (H*I,) becomes (I*H,), both contiguous.  ``field_params`` is
    ``{"trunk": [{"w", "b"}, ...], "out": {"w", "b"}}``."""
    w = field_params["out"]["w"]
    hh = w.shape[0]
    head_w = w.reshape(hh, hidden_dim, input_dim).transpose(1, 2)
    head_b = field_params["out"]["b"].reshape(hidden_dim, input_dim).T
    return {
        "trunk": [{"w": layer["w"], "b": layer["b"]}
                  for layer in field_params["trunk"]],
        "head_w": head_w.reshape(hh, input_dim * hidden_dim).contiguous(),
        "head_b": head_b.reshape(-1).contiguous(),
    }


def _mm(a, b, precision):
    """a @ b with at least float32 accumulation (the JAX package's ``_mm``):
    ``precision="bfloat16"`` rounds both operands to bf16 first; the
    product runs at ``promote(a.dtype, float32)``, so bf16 operands
    accumulate in float32 and a float64 run stays float64."""
    if precision == "bfloat16":
        a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    acc = torch.promote_types(a.dtype, torch.float32)
    return a.to(acc) @ b.to(acc)


def _forward_reference(trunk, head_w, head_b, z, dx, hidden_dim, input_dim,
                       precision="float32"):
    """Plain PyTorch version of the fused field (the JAX package's
    ``_forward_reference``): the products through :func:`_mm`, the bias
    add, relu, tanh and the dX sum at its accumulator dtype, only the
    result cast to ``z.dtype``.  Handles a head wider than ``hidden_dim``
    per channel by slicing the extra columns off."""
    hp = head_w.shape[-1] // input_dim
    u = z
    for layer in trunk:
        u = torch.relu(_mm(u, layer["w"], precision) + layer["b"])
    a = torch.tanh(_mm(u, head_w, precision) + head_b)  # (B, I*Hp)
    a = a.reshape(a.shape[:-1] + (input_dim, hp))
    out = torch.sum(a * dx[..., :, None], dim=-2)
    return out[..., :hidden_dim].to(z.dtype)


def _kernel_operands(trunk, head_w, head_b, z, dx, hidden_dim, input_dim, lead=()):
    """Every operand with the shape the kernel reads it at; ``lead`` is the
    replica dims of stacked operands, ``(K,)``, before every shape."""
    batch, hh = z.shape[len(lead)], head_w.shape[-2]
    operands = [("z", z, (batch, hidden_dim)), ("dx", dx, (batch, input_dim)),
                ("head_w", head_w, (hh, input_dim * hidden_dim)),
                ("head_b", head_b, (input_dim * hidden_dim,))]
    d_in = hidden_dim
    for l, layer in enumerate(trunk):
        operands += [(f"trunk[{l}].w", layer["w"], (d_in, hh)),
                     (f"trunk[{l}].b", layer["b"], (hh,))]
        d_in = hh
    return [(name, t, tuple(lead) + shape) for name, t, shape in operands]


def _check_precision(precision):
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")


def _check_operands(what, operands, device, n_trunk, dtypes=(torch.float32,),
                    replicas=False):
    """Raise on anything a kernel does not take: another device, a dtype
    not in ``dtypes`` or operands of more than one dtype, a non-contiguous
    operand, a wrong shape, 0 or more than MAX_TRUNK trunk layers, a
    ``torch.func`` wrapper (which has no storage).  With ``replicas`` the
    operands are stacked (K, ...): each replica contiguous, the replica
    stride free (0 for an operand the replicas share)."""
    if not 1 <= n_trunk <= MAX_TRUNK:
        raise ValueError(f"{what} takes 1..{MAX_TRUNK} trunk layers, got {n_trunk}")
    dtype = operands[0][1].dtype
    for name, t, shape in operands:
        if torch._C._functorch.is_functorch_wrapped_tensor(t):
            raise TypeError(f"{what}: {name} is a torch.func wrapper; transforms reach "
                            "the kernels through the fused field's Functions")
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, z on {device}")
        if t.dtype not in dtypes:
            names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
            raise TypeError(f"{what} takes {names}; {name} is {t.dtype}")
        if t.dtype != dtype:
            raise TypeError(f"{what} takes operands of one dtype; z is {dtype}, "
                            f"{name} is {t.dtype}")
        if t.shape != shape:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, want {shape}")
        if not (t[0] if replicas else t).is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
    if device.type == "cuda" and device.index != torch.cuda.current_device():
        raise ValueError(f"{what}: z is on {device}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")


def _pointers(tensors):
    return (ctypes.c_void_p * MAX_TRUNK)(*[t.data_ptr() for t in tensors])


def _flat_trunk(trunk):
    return [t for layer in trunk for t in (layer["w"], layer["b"])]


def _unflat_trunk(trunk_flat):
    return [{"w": trunk_flat[i], "b": trunk_flat[i + 1]}
            for i in range(0, len(trunk_flat), 2)]


@functools.lru_cache(maxsize=64)
def _forward_scratch_floats(batch, hidden_dim, hh, input_dim, n_trunk) -> int:
    """Floats of scratch the forward kernel needs at this shape (u_n on the
    tensor-core path; 0 for H or HH above 256), as the library computes
    it."""
    fn = fused_field_kernel.helper("oncde_fused_field_forward_scratch",
                                   [ctypes.c_int] * 5, ctypes.c_longlong)
    return int(fn(batch, hidden_dim, hh, input_dim, n_trunk))


def _forward_kernel(trunk, head_w, head_b, z, dx, hidden_dim, input_dim,
                    precision="float32"):
    """Launch ``csrc/fused_field.cu`` on the current stream; raises on
    anything the kernel does not take (:func:`_check_operands`)."""
    _check_precision(precision)
    _check_operands("fused field kernel",
                    _kernel_operands(trunk, head_w, head_b, z, dx, hidden_dim,
                                     input_dim), z.device, len(trunk), STORAGE)
    batch, hh = z.shape[0], head_w.shape[0]
    out = torch.empty((batch, hidden_dim), dtype=z.dtype, device=z.device)
    if batch == 0:
        return out
    n_scratch = _forward_scratch_floats(batch, hidden_dim, hh, input_dim, len(trunk))
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=z.device)
    fused_field_kernel(
        z.data_ptr(), dx.data_ptr(), _pointers(l["w"] for l in trunk),
        _pointers(l["b"] for l in trunk), len(trunk),
        head_w.data_ptr(), head_b.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), n_scratch, batch, hidden_dim, hh, input_dim,
        STORAGE.index(z.dtype), PRECISIONS.index(precision),
        torch.cuda.current_stream().cuda_stream,
    )
    return out


@torch.library.custom_op("oncde::fused_field_forward", mutates_args=(), device_types="cuda")
def fused_field_forward_op(z: torch.Tensor, dx: torch.Tensor, head_w: torch.Tensor,
                           head_b: torch.Tensor, trunk: list[torch.Tensor], hidden_dim: int,
                           input_dim: int, precision: str) -> torch.Tensor:
    """The fused field's forward as the op ``oncde::fused_field_forward``
    (``trunk`` flat: w_1, b_1, ..., w_n, b_n), so ``torch.export`` records
    it as one node of an exported program.  On a CUDA tensor it launches
    ``csrc/fused_field.cu`` (:func:`_forward_kernel`, which raises on
    anything the kernel does not take); on a CPU tensor it runs the plain
    version; its fake version gives the (B, H) output's shape."""
    return _forward_kernel(_unflat_trunk(trunk), head_w, head_b, z, dx, hidden_dim,
                           input_dim, precision)


@fused_field_forward_op.register_kernel("cpu")
def _(z, dx, head_w, head_b, trunk, hidden_dim, input_dim, precision):
    return _forward_reference(_unflat_trunk(trunk), head_w, head_b, z, dx, hidden_dim,
                              input_dim, precision)


@fused_field_forward_op.register_fake
def _(z, dx, head_w, head_b, trunk, hidden_dim, input_dim, precision):
    return z.new_empty((z.shape[0], hidden_dim))


def _forward(trunk, head_w, head_b, z, dx, hidden_dim, input_dim, precision="float32"):
    return fused_field_forward_op(z, dx, head_w, head_b, _flat_trunk(trunk), hidden_dim,
                                  input_dim, precision)


def _backward_reference(trunk, head_w, head_b, z, dx, g, hidden_dim, input_dim,
                        precision="float32", forward=None):
    """Plain PyTorch version of the fused field's VJP: autograd through
    :func:`_forward_reference`, as the JAX package's default route
    (``jax.vjp`` of its ``_forward_reference``), so it rounds where that
    does: a bf16 leaf's cotangent to bf16 after its full sum and, under
    ``precision="bfloat16"``, each product's cotangent for an operand cast
    to bf16.  Returns ``(dtrunk, dhw, dhb, dz, ddx)`` with ``dtrunk =
    [{"w", "b"}, ...]``, the order of ``_backward_pallas``."""
    forward = forward or _forward_reference
    leaves = [t.detach().requires_grad_()
              for t in (z, dx, head_w, head_b, *_flat_trunk(trunk))]
    z_, dx_, hw_, hb_, *flat = leaves
    with torch.enable_grad():
        out = forward(_unflat_trunk(flat), hw_, hb_, z_, dx_, hidden_dim, input_dim, precision)
        dz, ddx, dhw, dhb, *dflat = torch.autograd.grad(out, leaves, g)
    return _unflat_trunk(dflat), dhw, dhb, dz, ddx


@functools.lru_cache(maxsize=64)
def _backward_scratch_floats(batch, hidden_dim, hh, input_dim, n_trunk) -> int:
    """Floats of scratch the backward kernel needs at this shape (0 if it
    does not take it), as the library computes it."""
    fn = fused_field_bwd_kernel.helper("oncde_fused_field_backward_scratch",
                                       [ctypes.c_int] * 5, ctypes.c_longlong)
    return int(fn(batch, hidden_dim, hh, input_dim, n_trunk))


def _backward_kernel(trunk, head_w, head_b, z, dx, g, hidden_dim, input_dim,
                     precision="float32"):
    """Launch ``csrc/fused_field_bwd.cu`` on the current stream.  Same
    checks as :func:`_forward_kernel`, plus g (B, H); the library refuses
    any other shape it does not take (H or HH above its tile width), and
    the wrapper raises on that.  Returns what :func:`_backward_reference`
    returns."""
    _check_precision(precision)
    batch, hh = z.shape[0], head_w.shape[0]
    _check_operands("fused field backward kernel",
                    _kernel_operands(trunk, head_w, head_b, z, dx, hidden_dim,
                                     input_dim) + [("g", g, (batch, hidden_dim))],
                    z.device, len(trunk), STORAGE)
    dz, ddx = torch.empty_like(z), torch.empty_like(dx)
    dtrunk = [{"w": torch.empty_like(l["w"]), "b": torch.empty_like(l["b"])}
              for l in trunk]
    dhw, dhb = torch.empty_like(head_w), torch.empty_like(head_b)
    if batch == 0:
        for t in (*_flat_trunk(dtrunk), dhw, dhb):
            t.zero_()
        return dtrunk, dhw, dhb, dz, ddx
    n_scratch = _backward_scratch_floats(batch, hidden_dim, hh, input_dim, len(trunk))
    if n_scratch <= 0:
        max_dim = fused_field_bwd_kernel.helper(
            "oncde_fused_field_backward_max_dim", [], ctypes.c_int)()
        raise ValueError(f"fused field backward kernel does not take B={batch}, "
                         f"H={hidden_dim}, HH={hh}, I={input_dim} (it takes H and "
                         f"HH up to {max_dim})")
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=z.device)
    fused_field_bwd_kernel(
        z.data_ptr(), dx.data_ptr(), g.data_ptr(),
        _pointers(l["w"] for l in trunk), _pointers(l["b"] for l in trunk), len(trunk),
        head_w.data_ptr(), head_b.data_ptr(), dz.data_ptr(), ddx.data_ptr(),
        _pointers(l["w"] for l in dtrunk), _pointers(l["b"] for l in dtrunk),
        dhw.data_ptr(), dhb.data_ptr(), scratch.data_ptr(), n_scratch,
        batch, hidden_dim, hh, input_dim, STORAGE.index(z.dtype),
        PRECISIONS.index(precision), torch.cuda.current_stream().cuda_stream,
    )
    return dtrunk, dhw, dhb, dz, ddx


def _backward(trunk, head_w, head_b, z, dx, g, hidden_dim, input_dim,
              precision="float32"):
    if z.is_cuda:
        return _backward_kernel(trunk, head_w, head_b, z, dx, g, hidden_dim, input_dim,
                                precision)
    return _backward_reference(trunk, head_w, head_b, z, dx, g, hidden_dim, input_dim,
                               precision)


# ---------------------------------------------------------------------------
# K replicas: the stacked forms the Functions' vmap rules call.
# ---------------------------------------------------------------------------


def _forward_reference_multi(trunk, head_w, head_b, z, dx, hidden_dim, input_dim,
                             precision="float32"):
    """Plain version of :func:`fused_matmul_field_multi`: the single plain
    version's ops over the stacked (K, ...) operands (the biases broadcast
    over each replica's rows)."""
    trunk = [{"w": l["w"], "b": l["b"][:, None]} for l in trunk]
    return _forward_reference(trunk, head_w, head_b[:, None], z, dx, hidden_dim, input_dim,
                              precision)


def _backward_reference_multi(trunk, head_w, head_b, z, dx, g, hidden_dim, input_dim,
                              precision="float32"):
    """Plain version of :func:`fused_field_backward_multi`: autograd through
    :func:`_forward_reference_multi`, each replica's weight grads summed over
    its own rows; a shared (expanded) operand gets each replica's
    cotangent."""
    return _backward_reference(trunk, head_w, head_b, z, dx, g, hidden_dim, input_dim,
                               precision, forward=_forward_reference_multi)


def _input_strides(z, dx, g, head_w, head_b, trunk):
    """The multi entries' host array of replica strides (elements)."""
    slots = [z.stride(0), dx.stride(0), 0 if g is None else g.stride(0), head_w.stride(0),
             head_b.stride(0)] + [0] * (2 * MAX_TRUNK)
    for l, layer in enumerate(trunk):
        slots[5 + l] = layer["w"].stride(0)
        slots[5 + MAX_TRUNK + l] = layer["b"].stride(0)
    return (ctypes.c_longlong * _STRIDE_SLOTS)(*slots)


def _check_multi(what, trunk, head_w, head_b, z, dx, hidden_dim, input_dim, extra=()):
    if z.dim() != 3:
        raise ValueError(f"{what} takes stacked (K, B, H) states; z has shape "
                         f"{tuple(z.shape)}")
    _check_operands(what, _kernel_operands(trunk, head_w, head_b, z, dx, hidden_dim,
                                           input_dim, lead=z.shape[:1]) + list(extra),
                    z.device, len(trunk), STORAGE, replicas=True)


@functools.lru_cache(maxsize=64)
def _multi_scratch_floats(direction, replicas, batch, hidden_dim, hh, input_dim,
                          n_trunk) -> int:
    """Floats of scratch a multi entry needs at this shape (0 for a shape it
    does not take), as its library computes it."""
    kernel = {"forward": fused_field_multi_kernel,
              "backward": fused_field_bwd_multi_kernel}[direction]
    fn = kernel.helper(f"oncde_fused_field_{direction}_multi_scratch",
                       [ctypes.c_int] * 6, ctypes.c_longlong)
    return int(fn(replicas, batch, hidden_dim, hh, input_dim, n_trunk))


def _multi_scratch(what, direction, z, hidden_dim, hh, input_dim, n_trunk):
    """A multi entry's scratch on z's device; raises for a shape it does
    not take."""
    k, batch = z.shape[0], z.shape[1]
    n = _multi_scratch_floats(direction, k, batch, hidden_dim, hh, input_dim, n_trunk)
    if n <= 0:
        raise ValueError(f"{what} does not take K={k}, B={batch}, H={hidden_dim}, HH={hh}, "
                         f"I={input_dim} (it takes H and HH up to 256)")
    return torch.empty(n, dtype=torch.float32, device=z.device), n


def _forward_multi_kernel(trunk, head_w, head_b, z, dx, hidden_dim, input_dim,
                          precision="float32"):
    """Launch the multi entry of ``csrc/fused_field.cu`` on the current
    stream: one call's two launches, for every replica."""
    what = "fused field multi kernel"
    _check_precision(precision)
    _check_multi(what, trunk, head_w, head_b, z, dx, hidden_dim, input_dim)
    k, batch, hh = z.shape[0], z.shape[1], head_w.shape[-2]
    out = torch.empty((k, batch, hidden_dim), dtype=z.dtype, device=z.device)
    if batch == 0:
        return out
    scratch, n_scratch = _multi_scratch(what, "forward", z, hidden_dim, hh, input_dim,
                                        len(trunk))
    fused_field_multi_kernel(
        z.data_ptr(), dx.data_ptr(), _pointers(l["w"] for l in trunk),
        _pointers(l["b"] for l in trunk), len(trunk),
        head_w.data_ptr(), head_b.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), n_scratch, k, _input_strides(z, dx, None, head_w, head_b, trunk),
        batch, hidden_dim, hh, input_dim, STORAGE.index(z.dtype),
        PRECISIONS.index(precision), torch.cuda.current_stream().cuda_stream,
    )
    return out


def _backward_multi_kernel(trunk, head_w, head_b, z, dx, g, hidden_dim, input_dim,
                           precision="float32"):
    """Launch the multi entry of ``csrc/fused_field_bwd.cu``: one call's
    four launches, for every replica; every output (K, ...)."""
    what = "fused field backward multi kernel"
    _check_precision(precision)
    k, batch, hh = z.shape[0], z.shape[1], head_w.shape[-2]
    _check_multi(what, trunk, head_w, head_b, z, dx, hidden_dim, input_dim,
                 extra=[("g", g, (k, batch, hidden_dim))])
    dense = lambda t: torch.empty((k,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    dz, ddx = dense(z), dense(dx)
    dtrunk = [{"w": dense(l["w"]), "b": dense(l["b"])} for l in trunk]
    dhw, dhb = dense(head_w), dense(head_b)
    if batch == 0:
        for t in (*_flat_trunk(dtrunk), dhw, dhb):
            t.zero_()
        return dtrunk, dhw, dhb, dz, ddx
    scratch, n_scratch = _multi_scratch(what, "backward", z, hidden_dim, hh, input_dim,
                                        len(trunk))
    fused_field_bwd_multi_kernel(
        z.data_ptr(), dx.data_ptr(), g.data_ptr(),
        _pointers(l["w"] for l in trunk), _pointers(l["b"] for l in trunk), len(trunk),
        head_w.data_ptr(), head_b.data_ptr(), dz.data_ptr(), ddx.data_ptr(),
        _pointers(l["w"] for l in dtrunk), _pointers(l["b"] for l in dtrunk),
        dhw.data_ptr(), dhb.data_ptr(), scratch.data_ptr(), n_scratch, k,
        _input_strides(z, dx, g, head_w, head_b, trunk),
        batch, hidden_dim, hh, input_dim, STORAGE.index(z.dtype),
        PRECISIONS.index(precision), torch.cuda.current_stream().cuda_stream,
    )
    return dtrunk, dhw, dhb, dz, ddx


def fused_matmul_field_multi(trunk, head_w, head_b, z, dx, hidden_dim: int,
                             input_dim: int, precision: str = "float32") -> torch.Tensor:
    """K replicas of :func:`fused_matmul_field`'s op in one call.  Stacked
    operands: ``trunk`` a list of ``{'w': (K, d_in, HH), 'b': (K, HH)}``,
    ``head_w`` (K, HH, I*H), ``head_b`` (K, I*H), ``z`` (K, B, H), ``dx``
    (K, B, I); each replica contiguous, the replica stride free (0 for an
    operand the replicas share, an ``expand``).  Returns (K, B, H).  A CUDA
    tensor launches the forward kernel's multi entry (H and HH up to 256);
    a CPU tensor runs :func:`_forward_reference_multi`.  No gradient of its
    own: autograd and ``torch.func`` reach it through
    :func:`fused_matmul_field`."""
    _check_precision(precision)
    if z.is_cuda:
        return _forward_multi_kernel(trunk, head_w, head_b, z, dx, hidden_dim, input_dim,
                                     precision)
    return _forward_reference_multi(trunk, head_w, head_b, z, dx, hidden_dim, input_dim,
                                    precision)


def fused_field_backward_multi(trunk, head_w, head_b, z, dx, g, hidden_dim: int,
                               input_dim: int, precision: str = "float32"):
    """The VJP of :func:`fused_matmul_field_multi` for the cotangent ``g``
    (K, B, H): ``(dtrunk, dhead_w, dhead_b, dz, ddx)``, every one (K, ...)
    and each replica's own (a shared operand gets each replica's
    cotangent).  A CUDA tensor launches the backward kernel's multi entry;
    a CPU tensor runs :func:`_backward_reference_multi`."""
    _check_precision(precision)
    if z.is_cuda:
        return _backward_multi_kernel(trunk, head_w, head_b, z, dx, g, hidden_dim,
                                      input_dim, precision)
    return _backward_reference_multi(trunk, head_w, head_b, z, dx, g, hidden_dim, input_dim,
                                     precision)


def _stacked(k, in_dims, tensors):
    """A vmap rule's operands as (K, ...) tensors: a batched one with its
    replica dim moved to the front, each replica contiguous; an unbatched
    one expanded over the replicas at stride 0."""
    out = []
    for t, d in zip(tensors, in_dims):
        if d is None:
            t = t.contiguous().expand((k,) + tuple(t.shape))
        else:
            t = t.movedim(d, 0).contiguous()
        out.append(t)
    return out


class _FusedFieldMulti(torch.autograd.Function):
    """:func:`fused_matmul_field_multi` with its VJP,
    :func:`fused_field_backward_multi`: what :class:`_FusedField`'s vmap
    rule records when plain autograd differentiates through
    ``torch.func.vmap`` (the wave's step), so the backward runs the multi
    kernel with no transform around it.  A shared (expanded) operand's
    per-replica cotangents sum through the ``expand``."""

    @staticmethod
    def forward(ctx, hidden_dim, input_dim, precision, z, dx, head_w, head_b, *trunk_flat):
        ctx.dims = (hidden_dim, input_dim, precision)
        ctx.save_for_backward(z, dx, head_w, head_b, *trunk_flat)
        return fused_matmul_field_multi(_unflat_trunk(trunk_flat), head_w, head_b, z, dx,
                                        hidden_dim, input_dim, precision)

    @staticmethod
    def backward(ctx, g):
        z, dx, head_w, head_b, *trunk_flat = ctx.saved_tensors
        dtrunk, dhw, dhb, dz, ddx = fused_field_backward_multi(
            _unflat_trunk(trunk_flat), head_w, head_b, z, dx, g.contiguous(), *ctx.dims)
        return (None, None, None, dz, ddx, dhw, dhb, *_flat_trunk(dtrunk))


class _FusedField(torch.autograd.Function):
    """The fused field with its VJP (:class:`_FusedFieldBackward`) and a
    ``vmap`` rule onto the K-replica forms."""

    @staticmethod
    def forward(hidden_dim, input_dim, precision, z, dx, head_w, head_b, *trunk_flat):
        return _forward(_unflat_trunk(trunk_flat), head_w, head_b, z, dx,
                        hidden_dim, input_dim, precision)

    @staticmethod
    def setup_context(ctx, inputs, output):
        hidden_dim, input_dim, precision, *tensors = inputs
        ctx.dims = (hidden_dim, input_dim, precision)
        ctx.save_for_backward(*tensors)

    @staticmethod
    def backward(ctx, g):
        z, dx, head_w, head_b, *trunk_flat = ctx.saved_tensors
        grads = _FusedFieldBackward.apply(*ctx.dims, z, dx, g.contiguous(), head_w, head_b,
                                          *trunk_flat)
        return (None, None, None, *grads)

    @staticmethod
    def vmap(info, in_dims, hidden_dim, input_dim, precision, *tensors):
        stacked = _stacked(info.batch_size, in_dims[3:], tensors)
        return _FusedFieldMulti.apply(hidden_dim, input_dim, precision, *stacked), 0


class _FusedFieldBackward(torch.autograd.Function):
    """The fused field's VJP, ``(dz, ddx, dhead_w, dhead_b, dW_1, db_1,
    ...)``, with a ``vmap`` rule onto :func:`fused_field_backward_multi`
    (``torch.func.vmap`` of a gradient runs the backward under the
    transform too).  It has no gradient of its own, as the kernel pair."""

    @staticmethod
    def forward(hidden_dim, input_dim, precision, z, dx, g, head_w, head_b, *trunk_flat):
        dtrunk, dhw, dhb, dz, ddx = _backward(_unflat_trunk(trunk_flat), head_w, head_b, z,
                                              dx, g, hidden_dim, input_dim, precision)
        return (dz, ddx, dhw, dhb, *_flat_trunk(dtrunk))

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("the fused field's VJP has no gradient of its own "
                           "(as its kernel)")

    @staticmethod
    def vmap(info, in_dims, hidden_dim, input_dim, precision, *tensors):
        z, dx, g, head_w, head_b, *flat = _stacked(info.batch_size, in_dims[3:], tensors)
        dtrunk, dhw, dhb, dz, ddx = fused_field_backward_multi(
            _unflat_trunk(flat), head_w, head_b, z, dx, g, hidden_dim, input_dim, precision)
        outs = (dz, ddx, dhw, dhb, *_flat_trunk(dtrunk))
        return outs, (0,) * len(outs)


def fused_matmul_field(trunk, head_w, head_b, z, dx, hidden_dim: int,
                       input_dim: int, precision: str = "float32") -> torch.Tensor:
    """out = einsum('bih,bi->bh', tanh(trunk(z) @ head_w + head_b), dx).

    trunk: list of {'w', 'b'} relu layers; head_w: (HH, I*H)
    contraction-major; z: (..., H); dx: (..., I) with the same leading
    dims, flattened to the kernel's (B, H) and (B, I) and restored.
    ``precision="bfloat16"`` rounds every product's operands to bf16
    (float32 accumulation, as the JAX op).  Returns (..., H) in z's dtype.
    CUDA tensors go through the Hopper kernels (float32 or bfloat16, one
    dtype, contiguous, or they raise); CPU tensors through the plain
    versions (any float dtype).  Under a ``torch.func`` transform the op
    goes through its Function, whose ``vmap`` rule takes K replicas to
    :func:`fused_matmul_field_multi`.
    """
    _check_precision(precision)
    lead = z.shape[:-1]
    z = z.reshape(-1, hidden_dim)
    dx = dx.reshape(-1, input_dim)
    flat = _flat_trunk(trunk)
    operands = (z, dx, head_w, head_b, *flat)
    # Traced (``torch.export``'s scan bodies), the op is recorded as it is.
    if not torch.compiler.is_compiling() and (any(
            torch._C._functorch.is_functorch_wrapped_tensor(t) for t in operands) or (
            torch.is_grad_enabled() and any(t.requires_grad for t in operands))):
        out = _FusedField.apply(hidden_dim, input_dim, precision, z, dx, head_w, head_b,
                                *flat)
    else:
        out = _forward(trunk, head_w, head_b, z, dx, hidden_dim, input_dim, precision)
    return out.reshape(lead + (hidden_dim,))


# ---------------------------------------------------------------------------
# Whole-interval RK4 (3/8): the JAX ops fused_rk4_interval and
# fused_rk4_interval_multi.
# ---------------------------------------------------------------------------


def _widened(trunk, head_w, head_b, z, dx):
    """Every operand of a reduced-precision call widened to float32 (float32
    and float64 operands as they are)."""
    if z.dtype not in (torch.bfloat16, torch.float16):
        return trunk, head_w, head_b, z, dx
    f = lambda t: t.float()
    return ([{k: f(v) for k, v in layer.items()} for layer in trunk], f(head_w), f(head_b),
            f(z), f(dx))


def _rk4_interval_reference(trunk, head_w, head_b, z, dx, hidden_dim, input_dim):
    """Plain version of :func:`fused_rk4_interval`: the port's RK4 (3/8)
    stepper from t=0 to 1 over :func:`_forward_reference` -- the
    composition the JAX package holds its kernel against.  A bf16 call
    steps in float32 on its widened operands and rounds the result once to
    bf16, the JAX kernel's arithmetic (``z`` and ``dx`` cast to f32, f32
    products, the output in ``z.dtype``)."""
    wide = _widened(trunk, head_w, head_b, z, dx)
    trunk_, head_w_, head_b_, z_, dx_ = wide
    step = solvers.tree_fixed_step("rk4")
    out = step(lambda t, zz: _forward_reference(trunk_, head_w_, head_b_, zz, dx_,
                                                hidden_dim, input_dim), 0.0, 1.0, z_)
    return out.to(z.dtype)


def _replica(trunk, head_w, head_b, r):
    return [{"w": l["w"][r], "b": l["b"][r]} for l in trunk], head_w[r], head_b[r]


def _rk4_interval_multi_reference(trunk, head_w, head_b, z, dx, hidden_dim, input_dim):
    """Plain version of :func:`fused_rk4_interval_multi`: the single plain
    version on each replica in turn."""
    return torch.stack([
        _rk4_interval_reference(*_replica(trunk, head_w, head_b, r), z[r], dx[r],
                                hidden_dim, input_dim)
        for r in range(z.shape[0])])


def _check_rk4_call(what, trunk, head_w, head_b, z, dx, hidden_dim, input_dim):
    """What both interval ops refuse on every device: float16 storage (the
    port's interval ops take float32, bfloat16 and, on the CPU, float64, as
    its field ops), a padded head (the JAX ops' unpadded-packing assert)
    and a gradient request (they have no VJP)."""
    if z.dtype == torch.float16:
        raise TypeError(f"{what} takes float32 or bfloat16 (and float64 on the CPU), "
                        f"not {z.dtype}")
    if head_w.shape[-1] != input_dim * hidden_dim:
        raise ValueError(
            f"{what} takes the unpadded head (pack_fused_params): head_w has "
            f"{head_w.shape[-1]} columns, want input_dim * hidden_dim = "
            f"{input_dim * hidden_dim}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (z, dx, head_w, head_b, *_flat_trunk(trunk))):
        raise RuntimeError(
            f"{what} has no gradient (as the JAX op); call it under "
            "torch.no_grad() or on tensors that do not require grad")


def rk4_grid(batch, hidden_dim, hh, input_dim, n_trunk, replicas=1) -> dict:
    """The interval kernel's launch geometry for a call, as its library
    states it (for reports): the route it takes (the library picks it by
    the widths: the tensor cores up to 256, the CUDA cores above) and, on
    the tensor cores, the cluster size, rows a tile, clusters, blocks,
    clusters the card holds at once, shared memory a block, channels a head
    group, k rows a head chunk and state columns a rank."""
    fn = fused_rk4_kernel.helper("oncde_fused_rk4_grid", [ctypes.c_int] * 6
                                 + [ctypes.POINTER(ctypes.c_int)], ctypes.c_int)
    grid = (ctypes.c_int * 9)()
    taken = fn(replicas, batch, hidden_dim, hh, input_dim, n_trunk, grid)
    if taken < 0:
        return {"route": None}
    if taken == 0:
        return {"route": "cuda cores", "blocks": grid[3]}
    keys = ("cluster", "rows", "clusters", "blocks", "clusters_at_once", "smem_bytes",
            "channels_per_group", "k_rows_per_chunk", "strip")
    return {"route": "tensor cores", **dict(zip(keys, grid))}


@functools.lru_cache(maxsize=1)
def rk4_max_dim() -> int:
    """The largest H and HH the interval kernel takes (the CUDA-core
    route's shared-memory budget), as its library states it."""
    return int(fused_rk4_kernel.helper("oncde_fused_rk4_max_dim", [], ctypes.c_int)())


def _rk4_launch(kernel, what, z, dx, trunk, head_w, head_b, hidden_dim, input_dim,
                replicas=None):
    """Launch one of the interval kernel's entry points on the current
    stream, after the width check; returns the output."""
    hh = head_w.shape[-2]
    if max(hidden_dim, hh) > rk4_max_dim():
        raise ValueError(f"{what} does not take H={hidden_dim}, HH={hh} (it takes H "
                         f"and HH up to {rk4_max_dim()})")
    out = torch.empty_like(z)
    if z.numel() == 0:
        return out
    lead = () if replicas is None else (replicas,)
    kernel(z.data_ptr(), dx.data_ptr(), _pointers(l["w"] for l in trunk),
           _pointers(l["b"] for l in trunk), len(trunk), head_w.data_ptr(),
           head_b.data_ptr(), out.data_ptr(), *lead, z.shape[-2], hidden_dim, hh,
           input_dim, STORAGE.index(z.dtype), torch.cuda.current_stream().cuda_stream)
    return out


def _rk4_kernel(trunk, head_w, head_b, z, dx, hidden_dim, input_dim):
    """Launch ``csrc/fused_rk4_interval.cu`` for one model; the checks of
    :func:`_forward_kernel`, then the library's width limit."""
    _check_operands("fused RK4 interval kernel",
                    _kernel_operands(trunk, head_w, head_b, z, dx, hidden_dim,
                                     input_dim), z.device, len(trunk), STORAGE)
    return _rk4_launch(fused_rk4_kernel, "fused RK4 interval kernel", z, dx, trunk,
                       head_w, head_b, hidden_dim, input_dim)


def _rk4_multi_kernel(trunk, head_w, head_b, z, dx, hidden_dim, input_dim):
    """Launch the K-replica entry point of ``csrc/fused_rk4_interval.cu``."""
    what = "fused RK4 interval multi kernel"
    if z.dim() != 3 or head_w.dim() != 3:
        raise ValueError(f"{what} takes stacked (K, ...) operands; z has shape "
                         f"{tuple(z.shape)}, head_w {tuple(head_w.shape)}")
    _check_operands(what, _kernel_operands(trunk, head_w, head_b, z, dx, hidden_dim,
                                           input_dim, lead=z.shape[:1]),
                    z.device, len(trunk), STORAGE)
    return _rk4_launch(fused_rk4_multi_kernel, what, z, dx, trunk, head_w, head_b,
                       hidden_dim, input_dim, replicas=z.shape[0])


def fused_rk4_interval(trunk, head_w, head_b, z, dx, hidden_dim: int,
                       input_dim: int) -> torch.Tensor:
    """z after one unit interval of RK4 (3/8) under dz = f(z) dX with a
    constant increment ``dx`` (B, I): a caller with knot spacing dt passes
    dX/dt * dt.  Shapes as in :func:`fused_matmul_field`, 2-D, with the
    unpadded head (HH, I*H).  A CUDA tensor launches the Hopper kernel
    (float32 or bfloat16, one dtype, contiguous, or it raises); a CPU tensor
    runs :func:`_rk4_interval_reference` in float32, bfloat16 or float64.
    A bf16 state steps in float32 and only the result is rounded to bf16,
    as the JAX op.  No gradient."""
    _check_rk4_call("fused_rk4_interval", trunk, head_w, head_b, z, dx, hidden_dim,
                    input_dim)
    if z.is_cuda:
        return _rk4_kernel(trunk, head_w, head_b, z, dx, hidden_dim, input_dim)
    return _rk4_interval_reference(trunk, head_w, head_b, z, dx, hidden_dim, input_dim)


def fused_rk4_interval_multi(trunk, head_w, head_b, z, dx, hidden_dim: int,
                             input_dim: int) -> torch.Tensor:
    """K independent replicas' unit RK4 (3/8) intervals in one launch.
    Stacked layouts, as the JAX op: ``trunk`` a list of ``{'w': (K, d_in,
    HH), 'b': (K, HH)}``, ``head_w`` (K, HH, I*H) unpadded, ``head_b`` (K,
    I*H), ``z`` (K, B, H), ``dx`` (K, B, I).  Returns (K, B, H); replica r's
    result equals :func:`fused_rk4_interval` on its own operands (to the
    bit on the card).  Dispatch as :func:`fused_rk4_interval`."""
    _check_rk4_call("fused_rk4_interval_multi", trunk, head_w, head_b, z, dx,
                    hidden_dim, input_dim)
    if z.is_cuda:
        return _rk4_multi_kernel(trunk, head_w, head_b, z, dx, hidden_dim, input_dim)
    return _rk4_interval_multi_reference(trunk, head_w, head_b, z, dx, hidden_dim,
                                         input_dim)
