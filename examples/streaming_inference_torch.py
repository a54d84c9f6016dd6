"""Streaming (online) inference with the PyTorch port: advance a
rectilinear NCDE one observation at a time with ``OnlineNCDEStepper``.

The offline model consumes a whole precomputed coefficient array; an
online task receives observations one at a time.  Rectilinear
interpolation appends exactly two control pieces per observation, so the
hidden state advances incrementally and matches the offline forward.  The
counterpart of ``examples/streaming_inference.py``; the exported artifact
is ``torch.export``'s.

Run from the repo root (on the card; ``--device cpu`` without one):

    python examples/streaming_inference_torch.py [--device cpu]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch


def main(device=None):
    from online_neural_cdes_tpu_torch import (
        NeuralCDE, OnlineNCDEStepper, Predictor, linear_interpolation_coeffs,
    )
    from online_neural_cdes_tpu_torch.serving_export import export_predictor, load_predictor

    B, L, C = 8, 12, 3
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, L, C)).astype(np.float32)
    x[:, :, 0] = np.arange(L)                    # time channel
    x[rng.random(size=x.shape) < 0.2] = np.nan   # missing values
    x[:, :, 0] = np.arange(L)

    model = NeuralCDE(
        input_dim=C, hidden_dim=8, output_dim=1, num_layers=1,
        interpolation="rectilinear", return_sequences=True,
        adjoint=False, solver="rk4",
        generator=torch.Generator().manual_seed(0), device=device,
    )
    dev = model.device

    # Offline: one batched forward over the full (precomputed) path.
    with torch.no_grad():
        coeffs = linear_interpolation_coeffs(torch.from_numpy(x).to(dev), rectilinear=0)
        offline = model(coeffs)[..., 0].cpu().numpy()   # (B, L)

    # Online: feed observations one at a time.
    stepper = OnlineNCDEStepper(model, device=dev)
    state = stepper.init(torch.from_numpy(x[:, 0]).to(dev))
    print("t=0   offline", offline[0, 0].round(4),
          "streaming", round(float(stepper.readout(state["z"])[0, 0]), 4))
    worst = 0.0
    for t in range(1, L):
        state, y = stepper.step(state, torch.from_numpy(x[:, t]).to(dev))
        # The offline scan and the stepper sum in other orders: report the
        # worst deviation across the batch.
        diff = float(np.max(np.abs(y.cpu().numpy()[:, 0] - offline[:, t])))
        worst = max(worst, diff)
        print(f"t={t:<3d} offline {offline[0, t]:+.4f}  "
              f"streaming {float(y[0, 0]):+.4f}  max|batch diff|={diff:.1e}")

    # Batched serving with throughput mode: ragged request batches pad into
    # the bucket grid; ``predict_many`` keeps several batches in flight, so
    # each batch's host work overlaps the earlier batches' device work
    # (outputs equal per-call ``predict``).
    batch_model = NeuralCDE(
        input_dim=C, hidden_dim=8, output_dim=1, num_layers=1,
        interpolation="linear", return_sequences=False,
        adjoint=False, solver="rk4",
        generator=torch.Generator().manual_seed(1), device=dev,
    )
    predictor = Predictor(batch_model, coeff_fn=linear_interpolation_coeffs,
                          batch_buckets=(8,), length_multiple=8, device=dev)
    ragged = [x[i, : int(rng.integers(4, L))] for i in range(B)]
    batches = [ragged[:5], ragged[5:]]
    many = predictor.predict_many(batches, in_flight=2)
    per_call = [predictor.predict(b) for b in batches]
    same_many = all(np.array_equal(o, e) for outs, expected in zip(many, per_call)
                    for o, e in zip(outs, expected))
    print("predict_many (throughput mode) == per-call predict:", same_many)

    # Deployment: the predictor's whole bucket grid (coefficient build and
    # forward) exported with torch.export, then served back WITHOUT the
    # model object, as a production server loads it.
    with tempfile.TemporaryDirectory() as art:
        n = export_predictor(predictor, art, channels=C, max_length=L,
                             platforms=(dev.type,))
        loaded = load_predictor(art, device=dev)
        again = loaded.predict(batches[0])
        same_loaded = all(np.array_equal(a, b) for a, b in zip(again, per_call[0]))
        print(f"exported artifact ({n} shapes) serves identically:", same_loaded)
    return {"max_stream_diff": worst, "predict_many_equal": same_many,
            "artifact_equal": same_loaded}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cpu, or the CUDA card by default")
    main(ap.parse_args().device)
