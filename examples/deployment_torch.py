"""The train -> deploy -> serve -> retrain arc with the PyTorch port, with
no model code in the serving process.

A predictor's whole bucket grid is exported with
``serving_export.export_predictor`` (one self-contained directory:
``torch.export`` programs, ``params.npz`` and a manifest), loaded back
WITHOUT the model object, served bit-identically, served over a mesh, and
rolled forward to a new checkpoint with ``update_params`` (no re-export).
``params_dtype="bfloat16"`` shows the reduced-precision artifact (half the
weight payload).  The counterpart of ``examples/deployment.py``.

Run from the repo root (on the card; ``--device cpu`` without one):

    python examples/deployment_torch.py [--device cpu]
"""

import argparse
import os
import socket
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch
import torch.distributed as dist


def make_requests(n, C, seed=0):
    """Ragged raw series, time channel first, as the data pipeline emits."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        L = int(rng.integers(6, 20))
        s = rng.normal(size=(L, C)).astype(np.float32)
        s[:, 0] = np.arange(L)
        out.append(s)
    return out


def make_model(C, seed, device):
    from online_neural_cdes_tpu_torch import NeuralCDE

    return NeuralCDE(input_dim=C, hidden_dim=8, output_dim=2, num_layers=1,
                     interpolation="linear", adjoint=False, solver="rk4",
                     generator=torch.Generator().manual_seed(seed), device=device)


def main(device=None):
    from online_neural_cdes_tpu_torch import Predictor, linear_interpolation_coeffs
    from online_neural_cdes_tpu_torch.parallel.mesh import data_axis_size, make_mesh
    from online_neural_cdes_tpu_torch.serving_export import (
        export_predictor, load_predictor, update_params,
    )

    C = 3
    model = make_model(C, 0, device)     # stands in for a trained checkpoint
    dev = model.device
    serve = dict(coeff_fn=linear_interpolation_coeffs, batch_buckets=(4,),
                 length_multiple=8, device=dev)
    live = Predictor(model, **serve)
    reqs = make_requests(4, C)
    out = {}

    with tempfile.TemporaryDirectory() as art:
        # 1. Export: the bucket grid as torch.export programs, the weights
        #    an argument (not constants), so checkpoints stay swappable.
        n_shapes = export_predictor(live, art, channels=C, max_length=24,
                                    platforms=(dev.type,))
        print(f"exported {n_shapes} bucket shapes -> {art}")

        # 2. Serve with no model code, bit-identical to the live predictor.
        served = load_predictor(art, device=dev).predict(reqs)
        for a, b in zip(served, live.predict(reqs)):
            np.testing.assert_array_equal(a, b)
        print("loaded artifact serves bit-identically to the live predictor")

        # 3. Serve the SAME artifact over a mesh (data-parallel serving; a
        #    world of one here, the code path of N ranks).
        with socket.socket() as s:
            s.bind(("localhost", 0))
            address = f"tcp://localhost:{s.getsockname()[1]}"
        dist.init_process_group("gloo" if dev.type == "cpu" else "nccl",
                                init_method=address, world_size=1, rank=0)
        try:
            mesh = make_mesh(1, devices=dev.type)
            sharded = load_predictor(art, mesh=mesh).predict(reqs)
        finally:
            dist.destroy_process_group()
        for a, b in zip(sharded, served):
            np.testing.assert_array_equal(a, b)
        print(f"same artifact served over a {data_axis_size(mesh)}-rank mesh")

        # 4. Roll a retrained checkpoint in WITHOUT re-export: params.npz is
        #    rewritten atomically after its names and shapes are checked.
        new_model = make_model(C, 7, dev)
        update_params(art, new_model.state_dict())
        rolled = load_predictor(art, device=dev).predict(reqs)
        fresh = Predictor(new_model, **serve)
        for a, b in zip(rolled, fresh.predict(reqs)):
            np.testing.assert_array_equal(a, b)
        print("update_params rolled the new checkpoint in (no re-export)")

    # 5. Reduced-precision artifact: weights stored bfloat16, half the
    #    payload, outputs within bf16 tolerance of f32.
    with tempfile.TemporaryDirectory() as art16:
        export_predictor(live, art16, channels=C, max_length=24, platforms=(dev.type,),
                         params_dtype="bfloat16")
        outs16 = load_predictor(art16, device=dev).predict(reqs)
        scale = max(float(np.max(np.abs(o))) for o in served)
        out["bf16_deviation"] = max(float(np.max(np.abs(a - b)))
                                    for a, b in zip(outs16, served)) / scale
        print(f"bf16 artifact: relative deviation {out['bf16_deviation']:.1%} "
              "of output scale")
    print("deployment arc complete")
    out["shapes"] = n_shapes
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cpu, or the CUDA card by default")
    main(ap.parse_args().device)
