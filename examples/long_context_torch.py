"""Long-context Neural CDEs with the PyTorch port: the two length weapons.

1. **Log-ODE windows**: compress a long path into per-window depth-2
   log-signatures (length/window knots, more channels) and solve the CDE
   over the compressed control.
2. **The time-pipelined solve with its O(1)-activation adjoint**: split
   the knot axis over the ranks of a ``seq`` mesh and train through the
   reverse-schedule pipeline.

The script starts its own two gloo ranks on the CPU (one process each);
every rank passes the whole series and gets the same loss and gradients
back.  Rank 0 also runs the unpipelined model for comparison:

    python examples/long_context_torch.py
"""

import os
import socket
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

B, L, C, H = 32, 257, 3, 16
RANKS = 2


def series():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, L, C)).astype(np.float32) * 0.2
    x[:, :, 0] = np.arange(L) / L
    return x, (x[:, :, 1].sum(1) > 0).astype(np.float32)


def model(input_dim, adjoint, seed):
    from online_neural_cdes_tpu_torch import NeuralCDE

    return NeuralCDE(input_dim, H, 1, hidden_hidden_dim=H, num_layers=1,
                     interpolation="linear", adjoint=adjoint, solver="rk4",
                     generator=torch.Generator().manual_seed(seed), device="cpu")


def bce(logits, labels):
    return torch.nn.functional.binary_cross_entropy_with_logits(logits, labels)


def rank_main(rank, address, results):
    from online_neural_cdes_tpu_torch.data.loader import apply_logsig_transform
    from online_neural_cdes_tpu_torch.ops.interpolation import linear_interpolation_coeffs
    from online_neural_cdes_tpu_torch.parallel import make_sequence_mesh, ncde_apply_pipelined

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=address, world_size=RANKS, rank=rank)
    try:
        x, labels = series()
        labels = torch.from_numpy(labels)
        out = {}
        if rank == 0:
            # 1. log-ODE compression: 257 observations -> 33 knots x 6 channels.
            xl = apply_logsig_transform(x, depth=2, window=8, device="cpu")
            m = model(xl.shape[-1], True, 0)
            with torch.no_grad():
                logits = m(linear_interpolation_coeffs(torch.from_numpy(xl)))
            out["logode"] = (x.shape, xl.shape, logits[:3, 0].tolist())

        # 2. the raw path over the seq mesh, trained through the adjoint.
        mesh = make_sequence_mesh(RANKS, devices="cpu")
        coeffs = linear_interpolation_coeffs(torch.from_numpy(x))
        m = model(C, False, 1)
        logits = ncde_apply_pipelined(m, coeffs, mesh=mesh, microbatches=4, adjoint=True)
        loss = bce(logits[:, 0], labels)
        loss.backward()
        out["loss"] = float(loss.detach())
        out["grad_norm"] = float(sum((p.grad ** 2).sum() for p in m.parameters()) ** 0.5)
        if rank == 0:
            # The same model in one process.
            single = model(C, True, 1)
            with torch.no_grad():
                out["single_loss"] = float(bce(single(coeffs)[:, 0], labels))
        results.put((rank, out))
    finally:
        dist.destroy_process_group()


def main():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        address = f"tcp://localhost:{s.getsockname()[1]}"
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    mp.spawn(rank_main, args=(address, results), nprocs=RANKS)
    out = dict(results.get() for _ in range(RANKS))
    shape, compressed, logits = out[0]["logode"]
    print(f"log-ODE: {shape} -> {compressed}")
    print("compressed-control logits:", np.round(logits, 4))
    for rank in range(RANKS):
        print(f"rank {rank}: pipelined adjoint loss {out[rank]['loss']:.6f}, "
              f"grad-norm {out[rank]['grad_norm']:.6f} "
              f"({L - 1} knots over {RANKS} ranks)")
    print(f"one process: loss {out[0]['single_loss']:.6f}")
    return out


if __name__ == "__main__":
    main()
