"""The plain reference of the benchmark's online Neural CDE.

Plain PyTorch, written from the model's equations (arXiv:2106.11028 and
the configurations under ``port_bench/configs``), with no kernel, no
cache and no batching trick; it imports nothing of the program under
test.  It works everything out from the raw series the benchmark makes:

- the field f(z) = tanh(relu(relu(z W_1 + b_1) W_2 + b_2) W_o + b_o),
  reshaped (H, C), contracted with the control's derivative dX/dt;
- the controls on the unit knot grid: rectilinear (forward fill, then each
  observation split into a time piece and a value piece) or the cubic
  Hermite spline with backward differences (interior holes filled
  linearly, end holes by the nearest observation);
- z_0 = [static, X(0)] W_init + b_init, RK4 (the 3/8 rule) one step a
  piece, a readout [z] W_final + b_final at every observation;
- the masked BCE with logits, its gradient by the interval adjoint (each
  piece's augmented state (z, a_z, a_theta) integrated in reverse by the
  same RK4 from the forward's state at the piece's end, the loss's
  cotangent added at each knot), and Adam with a 10x learning rate on the
  readout;
- the online stepper: NaN holds the last observed value (NaN in the first
  observation becomes 0), and each new observation advances the state
  through its time piece and then its value piece.

``tf32=True`` rounds both operands of every product to TF32 (10 mantissa
bits, round to nearest, ties away from zero; the products and sums stay
float32), which is what the card's TF32 tensor cores compute: the control
that a comparison has to refuse.  Otherwise every product is float32 with
TF32 switched off.
"""

from __future__ import annotations

import torch

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8
FIELD = ("field.trunk.0.w", "field.trunk.0.b", "field.trunk.1.w", "field.trunk.1.b",
         "field.out.w", "field.out.b")


def no_tf32():
    """Float32 products stay float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32: the 13 low mantissa bits cleared,
    rounding to nearest with ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """a @ b with both operands rounded to TF32, and so are the operands of
    the two products of its gradient."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = tf32_round(a), tf32_round(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        return g @ b.transpose(-1, -2), a.transpose(-1, -2) @ g


def mm(a, b, tf32):
    return _TF32MatMul.apply(a, b) if tf32 else a @ b


def field(p, z, dx, tf32=False):
    """f(z) dX/dt for states ``z`` (N, H) and control derivatives ``dx``
    (N, C), the weights ``p`` keyed as the model's ``state_dict``."""
    n, h, c = z.shape[0], z.shape[1], dx.shape[-1]
    u = torch.relu(mm(z, p["field.trunk.0.w"], tf32) + p["field.trunk.0.b"])
    u = torch.relu(mm(u, p["field.trunk.1.w"], tf32) + p["field.trunk.1.b"])
    a = torch.tanh(mm(u, p["field.out.w"], tf32) + p["field.out.b"]).reshape(n, h, c)
    return mm(a, dx[:, :, None], tf32)[:, :, 0]


def rk4(f, z, frac_fn):
    """One RK4 (3/8 rule) step of unit length on a state ``z`` (a tensor or
    a tuple of tensors, ``f(state, frac)`` returning one of the same
    structure); ``frac_fn(c)`` maps a stage's offset c in [0, 1] to the
    piece's time."""
    def ax(y, *terms):
        if isinstance(y, torch.Tensor):
            return y + sum(c * k for c, k in terms)
        return tuple(yi + sum(c * k[i] for c, k in terms) for i, yi in enumerate(y))

    third = 1.0 / 3.0
    k1 = f(z, frac_fn(0.0))
    k2 = f(ax(z, (third, k1)), frac_fn(third))
    k3 = f(ax(z, (-third, k1), (1.0, k2)), frac_fn(2 * third))
    k4 = f(ax(z, (1.0, k1), (-1.0, k2), (1.0, k3)), frac_fn(1.0))
    return ax(z, (0.125, k1), (0.375, k2), (0.375, k3), (0.125, k4))


# -- controls ---------------------------------------------------------------

def forward_fill(x):
    """(N, L, C): each NaN takes the last observed value before it (leading
    NaNs stay NaN)."""
    out, last = [], x[:, 0]
    for i in range(x.shape[1]):
        last = torch.where(torch.isnan(x[:, i]), last, x[:, i])
        out.append(last)
    return torch.stack(out, dim=1)


def back_fill(x):
    """(N, L, C): each NaN takes the next observed value after it."""
    return torch.flip(forward_fill(torch.flip(x, dims=(1,))), dims=(1,))


def end_fill(x):
    """For a forward-filled ``x``: NaNs before the first observation take
    the first observed value; a channel with no observation becomes 0."""
    return torch.nan_to_num(back_fill(x), nan=0.0)


def linear_fill(x):
    """Interior NaNs linearly interpolated on the unit knot grid between the
    observations either side, end NaNs the nearest observation, a channel
    with no observation 0."""
    n, length, c = x.shape
    idx = torch.arange(length, dtype=x.dtype, device=x.device)[None, :, None].expand(n, length, c)
    obs = ~torch.isnan(x)
    t_obs = torch.where(obs, idx, torch.full_like(idx, float("nan")))
    t_prev, x_prev = forward_fill(t_obs), forward_fill(x)
    t_next, x_next = back_fill(t_obs), back_fill(x)
    span = t_next - t_prev
    inner = x_prev + (idx - t_prev) / torch.where(span == 0, torch.ones_like(span), span) \
        * (x_next - x_prev)
    ends = torch.where(torch.isnan(t_prev), x_next, torch.where(torch.isnan(t_next), x_prev,
                                                                 inner))
    return torch.nan_to_num(torch.where(obs, x, ends), nan=0.0)


def rectilinear_knots(x, time_channel=0):
    """(N, 2L-1, C): observation i's values held while the time moves to
    observation i+1's, then its values moved at that time."""
    filled = end_fill(forward_fill(x))
    knots = filled.repeat_interleave(2, dim=1)[:, :-1].clone()
    knots[:, 1::2, time_channel] = filled[:, 1:, time_channel]
    return knots


class Control:
    """A control on the unit knot grid: ``x0`` (N, C) and ``derivative(i,
    frac)`` on piece i."""

    def __init__(self, interpolation, x):
        if interpolation == "rectilinear":
            knots = rectilinear_knots(x)
            self.x0 = knots[:, 0]
            self.slopes = knots[:, 1:] - knots[:, :-1]
            self.n_pieces = knots.shape[1] - 1
            self.cubic = False
        elif interpolation == "hermite":
            v = linear_fill(x)
            self.x0 = v[:, 0]
            m = v[:, 1:] - v[:, :-1]                   # slope of each piece
            d0 = torch.cat([m[:, :1], m[:, :-1]], dim=1)   # backward difference at its start
            d1 = m                                     # ... and at its end
            self.b = d0
            self.two_c = 2.0 * (3.0 * m - 2.0 * d0 - d1)
            self.three_d = 3.0 * (d0 + d1 - 2.0 * m)
            self.n_pieces = v.shape[1] - 1
            self.cubic = True
        else:
            raise ValueError(f"no reference control for {interpolation!r}")

    def derivative(self, i, frac):
        if not self.cubic:
            return self.slopes[:, i]
        return self.b[:, i] + (self.two_c[:, i] + self.three_d[:, i] * frac) * frac


# -- the offline model, its loss and gradient, Adam -------------------------

def initial_state(p, static, x0, tf32=False):
    return mm(torch.cat([static, x0], dim=-1), p["initial.w"], tf32) + p["initial.b"]


def readout(p, z, tf32=False):
    return mm(z, p["final.w"], tf32) + p["final.b"]


def solve(p, control, z0, tf32=False):
    """The states at every knot, (K, N, H)."""
    zs = [z0]
    for i in range(control.n_pieces):
        zs.append(rk4(lambda z, frac: field(p, z, control.derivative(i, frac), tf32),
                      zs[-1], lambda c: c))
    return torch.stack(zs)


def bce_mean(logits, labels):
    """Mean BCE with logits over the labels that are not NaN."""
    keep = ~torch.isnan(labels)
    y = torch.where(keep, labels, torch.zeros_like(labels))
    per = torch.clamp_min(logits, 0) - logits * y + torch.log1p(torch.exp(-logits.abs()))
    per = torch.where(keep, per, torch.zeros_like(per))
    return per.sum() / torch.clamp_min(keep.sum(), 1)


def loss_and_grads(p, interpolation, x, static, labels, tf32=False):
    """(loss, gradients keyed as ``p``) of one batch: the forward solve
    without a graph, the loss's cotangent on every knot state, then the
    interval adjoint piece by piece in reverse."""
    control = Control(interpolation, x)
    leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
    with torch.no_grad():
        z0 = initial_state(p, static, control.x0, tf32)
        zs = solve(p, control, z0, tf32)
    knots = zs.detach().requires_grad_()
    with torch.enable_grad():
        logits = readout(leaves, knots.movedim(0, 1), tf32)[..., 0]     # (N, K)
        if interpolation == "rectilinear":
            logits = logits[:, ::2]
        loss = bce_mean(logits, labels)
        g_knots, g_fw, g_fb = torch.autograd.grad(loss, [knots, leaves["final.w"],
                                                         leaves["final.b"]])
    field_leaves = [leaves[k] for k in FIELD]
    a = torch.zeros_like(z0)
    a_theta = tuple(torch.zeros_like(t) for t in field_leaves)
    for i in range(control.n_pieces - 1, -1, -1):
        a = a + g_knots[i + 1]

        def aug(state, frac, i=i):
            z, a_, *_ = state
            with torch.enable_grad():
                z_ = z.detach().requires_grad_()
                f = field(leaves, z_, control.derivative(i, frac), tf32)
                vjps = torch.autograd.grad(f, [z_, *field_leaves], a_)
            return (-f.detach(), *vjps)

        # Reverse time s = -tau from the piece's end: stage c sits at piece time 1 - c.
        _, a, *a_theta = rk4(aug, (zs[i + 1], a, *a_theta), lambda c: 1.0 - c)
    a = a + g_knots[0]
    with torch.enable_grad():
        z0_ = initial_state(leaves, static, control.x0, tf32)
        g_iw, g_ib = torch.autograd.grad(z0_, [leaves["initial.w"], leaves["initial.b"]], a)
    grads = dict(zip(FIELD, a_theta))
    grads.update({"initial.w": g_iw, "initial.b": g_ib, "final.w": g_fw, "final.b": g_fb})
    return loss.detach(), grads


def train_steps(p0, interpolation, batches, lr, final_mult=10.0, tf32=False,
                half_batch=False):
    """Adam from the weights ``p0`` over ``batches``, a list of (x, static,
    labels).  Returns (the losses, the first step's gradients, the weights
    after the last step).  ``half_batch`` takes each step's loss over the
    first half of the rows only (a fault the comparison must refuse)."""
    p = {k: v.detach().clone() for k, v in p0.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first = [], None
    for t, (x, static, labels) in enumerate(batches, start=1):
        if half_batch:
            rows = x.shape[0] // 2
            x, static, labels = x[:rows], static[:rows], labels[:rows]
        loss, g = loss_and_grads(p, interpolation, x, static, labels, tf32)
        losses.append(loss)
        first = g if first is None else first
        for k in p:
            m[k] = BETA1 * m[k] + (1 - BETA1) * g[k]
            v2[k] = BETA2 * v2[k] + (1 - BETA2) * g[k] * g[k]
            step = lr * (final_mult if k.startswith("final.") else 1.0)
            m_hat = m[k] / (1 - BETA1 ** t)
            v_hat = v2[k] / (1 - BETA2 ** t)
            p[k] = p[k] - step * m_hat / (torch.sqrt(v_hat) + EPS)
    return torch.stack(losses), first, p


# -- the online stepper ------------------------------------------------------

def tick_cycle(p, static, bank, tf32=False, time_channel=0):
    """Scores of ``bank`` (T, N, C) streamed one observation a tick: the
    state from observation 0, then a score at each of observations 1 ..
    T-1.  Returns (T-1, N)."""
    x0 = torch.nan_to_num(bank[0], nan=0.0)
    z, prev = initial_state(p, static, x0, tf32), x0
    scores = []
    for k in range(1, bank.shape[0]):
        filled = torch.where(torch.isnan(bank[k]), prev, bank[k])
        dx_time = torch.zeros_like(filled)
        dx_time[:, time_channel] = filled[:, time_channel] - prev[:, time_channel]
        dx_value = filled - prev
        dx_value[:, time_channel] = 0.0
        for dx in (dx_time, dx_value):
            z = rk4(lambda zz, frac, dx=dx: field(p, zz, dx, tf32), z, lambda c: c)
        scores.append(readout(p, z, tf32)[:, 0])
        prev = filled
    return torch.stack(scores)
