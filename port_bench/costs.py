"""Operations and bytes of the port's field kernels, counted from shapes,
and the H100's published peaks.

Frozen copies of ``chip_smoke.py::field_cost``, ``field_bwd_cost`` and
``rk4_cost`` (the repository root's smoke run); only the names of the
arguments are spelt out.  A roofline share prices f32 work at the dense
TF32 tensor-core rate, the fastest at which the card takes f32 operands,
so no implementation that keeps f32 operands can read over 100%.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit.
TF32_FLOPS = 495e12
HBM_BYTES = 3.35e12


def field_cost(B, Hd, HHd, I, n, elem=4):
    """Operations and the least bytes moved (each input read once, the
    output written once) of one fused-field call, ``elem`` bytes an
    element (4: f32)."""
    weights = Hd * HHd + (n - 1) * HHd * HHd + n * HHd + HHd * I * Hd + I * Hd
    flops = 2 * B * (Hd * HHd + (n - 1) * HHd * HHd + HHd * I * Hd + I * Hd)
    nbytes = elem * (B * Hd + B * I + weights + B * Hd)
    return flops, nbytes


def field_bwd_cost(B, Hd, HHd, I, n, elem=4):
    """Operations (forward recompute, weight grads and input grads of every
    product) and the least bytes (inputs z, dX, g and the weights read
    once; dz, ddX and the weight grads written once) of one backward call,
    ``elem`` bytes an element (4: f32)."""
    weights = Hd * HHd + (n - 1) * HHd * HHd + n * HHd + HHd * I * Hd + I * Hd
    flops = 3 * 2 * B * (Hd * HHd + (n - 1) * HHd * HHd + HHd * I * Hd)
    nbytes = elem * (2 * B * Hd + B * I + weights + B * Hd + B * I + weights)
    return flops, nbytes


def rk4_cost(B, Hd, HHd, I, n, K=1, elem=4):
    """One RK4 interval: four field evaluations' operations; the bytes of
    one (z, dX and the weights read once, the state written once), ``elem``
    bytes an element; K replicas K times both."""
    flops, nbytes = field_cost(B, Hd, HHd, I, n, elem)
    return K * 4 * flops, K * nbytes


def bound_s(flops, nbytes):
    """The least seconds the card could take: the larger of the operations
    at the TF32 rate and the bytes at the HBM rate."""
    return max(flops / TF32_FLOPS, nbytes / HBM_BYTES)


def call_bound_s(kind, batch, cfg, channels):
    """``bound_s`` of one forward (``kind="forward"``) or backward call of
    the fused field at ``batch`` rows and ``channels`` control channels,
    the widths from the configuration ``cfg``."""
    cost = field_cost if kind == "forward" else field_bwd_cost
    return bound_s(*cost(batch, cfg["hidden_dim"], cfg["hidden_hidden_dim"], channels,
                         cfg["num_layers"]))


def pieces(cfg, length):
    """``[(I, pieces), ...]`` of one series of ``length`` observations:
    the rectilinear scan alternates time pieces (I=1) with value pieces
    (I=C); every other spline's pieces take all C channels."""
    c = cfg["input_dim"]
    if cfg["interpolation"] == "rectilinear":
        return [(1, length - 1), (c, length - 1)]
    return [(c, length - 1)]


def train_step_flops(cfg, batch, length):
    """The operations one training step needs by its schedule, whatever
    implements it: every piece's RK4 stages forward (``field_cost``) and
    every stage of the interval adjoint's reverse solve, each a field
    evaluation with its VJP (``field_bwd_cost``, which counts the
    evaluation too).  The readout, the loss and Adam are left out (under
    0.1% at these widths)."""
    hd, hh, n = cfg["hidden_dim"], cfg["hidden_hidden_dim"], cfg["num_layers"]
    total = 0
    for channels, count in pieces(cfg, length):
        total += 4 * count * (field_cost(batch, hd, hh, channels, n)[0]
                              + field_bwd_cost(batch, hd, hh, channels, n)[0])
    return total


def tick_flops(cfg, streams):
    """The operations one stepper tick needs: the time piece (I=1) and the
    value piece (I=C), four RK4 stages each."""
    hd, hh, n, c = (cfg["hidden_dim"], cfg["hidden_hidden_dim"], cfg["num_layers"],
                    cfg["input_dim"])
    return 4 * (field_cost(streams, hd, hh, 1, n)[0] + field_cost(streams, hd, hh, c, n)[0])
