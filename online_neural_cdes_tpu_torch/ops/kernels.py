"""The fused CDE vector field: trunk -> tanh head -> dX contraction.

PyTorch counterpart of ``fused_matmul_field`` in the JAX package's
``ops/kernels.py``.  Per RK stage a matmul-type Neural CDE computes

    u   = relu(... relu(z @ W_1 + b_1) ... @ W_n + b_n)
    A   = tanh(u @ W_o + b_o)                 # (B, I*H), never stored
    out = einsum('bih,bi->bh', A, dX)

On a CUDA tensor :func:`fused_matmul_field` launches the hand-written
Hopper kernel ``csrc/fused_field.cu`` (the port of the TPU kernel
``_forward_pallas``); on a CPU tensor it runs the plain version
:func:`_forward_reference`, line for line the JAX package's
``_forward_reference``.  The choice follows the tensor's device only:
nothing falls back from the kernel to the plain version.

The head is packed contraction-major, (HH, I*H), unpadded: the TPU's
128-lane padding is a layout rule of that chip and is not carried over.

Gradients are the training slice's work: when autograd records the op
(grad mode on and an input that requires grad) it goes through a
``torch.autograd.Function`` whose backward raises on every device, so a
gradient through the port fails loudly instead of differing between the
CPU and the card.  Otherwise the op is called directly, without an
autograd node.
"""

from __future__ import annotations

import ctypes

import torch

from online_neural_cdes_tpu_torch.utils.cuda_build import CudaKernel

__all__ = ["fused_matmul_field", "pack_fused_params", "fused_field_kernel"]

MAX_TRUNK = 4

# The Hopper kernel's launcher; ``fused_field_kernel.launches`` counts its
# launches.
fused_field_kernel = CudaKernel(
    "fused_field.cu",
    "oncde_fused_field_forward",
    [ctypes.c_void_p, ctypes.c_void_p,                  # z, dx
     ctypes.POINTER(ctypes.c_void_p),                   # trunk weights
     ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,     # trunk biases, n
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # head_w, head_b, out
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, H, HH, I
     ctypes.c_void_p],                                  # stream
)


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


def _forward_reference(trunk, head_w, head_b, z, dx, hidden_dim, input_dim):
    """Plain PyTorch version of the fused field (the JAX package's
    ``_forward_reference``).  Handles a head wider than ``hidden_dim`` per
    channel by slicing the extra columns off."""
    hp = head_w.shape[-1] // input_dim
    u = z
    for layer in trunk:
        u = torch.relu(u @ layer["w"] + layer["b"])
    a = torch.tanh(u @ head_w + head_b)  # (B, I*Hp)
    a = a.reshape(a.shape[:-1] + (input_dim, hp))
    out = torch.sum(a * dx[..., :, None], dim=-2)
    return out[..., :hidden_dim].to(z.dtype)


def _kernel_operands(trunk, head_w, head_b, z, dx, hidden_dim, input_dim):
    """Every operand with the shape the kernel reads it at."""
    batch, hh = z.shape[0], head_w.shape[0]
    operands = [("z", z, (batch, hidden_dim)), ("dx", dx, (batch, input_dim)),
                ("head_w", head_w, (hh, input_dim * hidden_dim)),
                ("head_b", head_b, (input_dim * hidden_dim,))]
    d_in = hidden_dim
    for l, layer in enumerate(trunk):
        operands += [(f"trunk[{l}].w", layer["w"], (d_in, hh)),
                     (f"trunk[{l}].b", layer["b"], (hh,))]
        d_in = hh
    return operands


def _forward_kernel(trunk, head_w, head_b, z, dx, hidden_dim, input_dim):
    """Launch ``csrc/fused_field.cu`` on the current stream.  Raises on
    anything the kernel does not take: another device, a dtype other than
    float32, a non-contiguous operand, a wrong shape, 0 or more than
    MAX_TRUNK trunk layers."""
    if not 1 <= len(trunk) <= MAX_TRUNK:
        raise ValueError(f"fused field kernel takes 1..{MAX_TRUNK} trunk "
                         f"layers, got {len(trunk)}")
    for name, t, shape in _kernel_operands(trunk, head_w, head_b, z, dx,
                                           hidden_dim, input_dim):
        if t.device != z.device:
            raise ValueError(f"fused field kernel: {name} is on {t.device}, "
                             f"z on {z.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"fused field kernel takes float32; {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"fused field kernel: {name} is not contiguous")
        if t.shape != shape:
            raise ValueError(f"fused field kernel: {name} has shape "
                             f"{tuple(t.shape)}, want {shape}")
    batch = z.shape[0]
    out = torch.empty((batch, hidden_dim), dtype=z.dtype, device=z.device)
    if batch == 0:
        return out
    pointers = ctypes.c_void_p * MAX_TRUNK
    trunk_w = pointers(*[layer["w"].data_ptr() for layer in trunk])
    trunk_b = pointers(*[layer["b"].data_ptr() for layer in trunk])
    if z.device.index != torch.cuda.current_device():
        raise ValueError(f"fused field kernel: z is on {z.device}, the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    fused_field_kernel(
        z.data_ptr(), dx.data_ptr(), trunk_w, trunk_b, len(trunk),
        head_w.data_ptr(), head_b.data_ptr(), out.data_ptr(),
        batch, hidden_dim, head_w.shape[0], input_dim,
        torch.cuda.current_stream().cuda_stream,
    )
    return out


def _forward(trunk, head_w, head_b, z, dx, hidden_dim, input_dim):
    if z.is_cuda:
        return _forward_kernel(trunk, head_w, head_b, z, dx, hidden_dim, input_dim)
    return _forward_reference(trunk, head_w, head_b, z, dx, hidden_dim, input_dim)


class _FusedField(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden_dim, input_dim, z, dx, head_w, head_b, *trunk_flat):
        trunk = [{"w": trunk_flat[i], "b": trunk_flat[i + 1]}
                 for i in range(0, len(trunk_flat), 2)]
        return _forward(trunk, head_w, head_b, z, dx, hidden_dim, input_dim)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("training slice: port _backward_pallas")


def fused_matmul_field(trunk, head_w, head_b, z, dx, hidden_dim: int,
                       input_dim: int) -> torch.Tensor:
    """out = einsum('bih,bi->bh', tanh(trunk(z) @ head_w + head_b), dx).

    trunk: list of {'w', 'b'} relu layers; head_w: (HH, I*H)
    contraction-major; z: (..., H); dx: (..., I) with the same leading
    dims, flattened to the kernel's (B, H) and (B, I) and restored.
    Returns (..., H).  CUDA tensors go through the Hopper kernel (float32,
    contiguous, or it raises); CPU tensors through the plain version (any
    float dtype).
    """
    lead = z.shape[:-1]
    z = z.reshape(-1, hidden_dim)
    dx = dx.reshape(-1, input_dim)
    flat = [t for layer in trunk for t in (layer["w"], layer["b"])]
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (z, dx, head_w, head_b, *flat)):
        # Recorded for autograd, whose backward raises.
        out = _FusedField.apply(hidden_dim, input_dim, z, dx, head_w, head_b, *flat)
    else:
        out = _forward(trunk, head_w, head_b, z, dx, hidden_dim, input_dim)
    return out.reshape(lead + (hidden_dim,))
