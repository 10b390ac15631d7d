"""Export the serving ETA model as a ``torch.export`` artifact.

The counterpart of ``scripts/export_model.py``: reads an ``RTPU1``
artifact (``save_model``), exports its plain forward with a symbolic
batch dimension (``train/checkpoint.py::export_serving_fn``) on the
device it will serve on, and writes a file the serving layer runs
without the model code: point ``ETA_MODEL_PATH`` at it and
``EtaService`` serves it (kernel ``torch_export``). Before declaring
success it loads the file back and scores 64 synthetic rows: bitwise the
program it saved, and within the policy's tolerance of the module's own
forward. The file holds ``torch.export`` bytes, which only the torch
minor version that wrote them loads.

    python -m routest_tpu_torch.train.export [--model PATH] [--out PATH]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m routest_tpu_torch.train.export")
    parser.add_argument("--model", default=None,
                        help="RTPU1 artifact (default: ETA_MODEL_PATH, "
                             "else the in-repo artifact)")
    parser.add_argument("--out", default=None,
                        help="output path (default: <model>.pt2)")
    parser.add_argument("--device", default=None,
                        help="cuda or cpu (default: ROUTEST_DEVICE, "
                             "else cuda)")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from routest_tpu_torch.core.config import resolve_device
    from routest_tpu_torch.core.dtypes import backend_compute_policy
    from routest_tpu_torch.data.features import batch_from_mapping
    from routest_tpu_torch.data.synthetic import generate_dataset
    from routest_tpu_torch.train.checkpoint import (default_model_path,
                                                    export_serving_fn,
                                                    load_exported_serving_fn,
                                                    load_model)
    from routest_tpu_torch.utils.logging import get_logger

    log = get_logger("routest_tpu_torch.train.export")
    device = resolve_device(args.device, "train.export")
    model_path = args.model or default_model_path()
    out = args.out or os.path.splitext(model_path)[0] + ".pt2"
    model, _ = load_model(model_path)
    # The policy the service would serve this artifact at on ``device``.
    model.policy = backend_compute_policy(model.policy, device)
    program = export_serving_fn(out, model, device)

    loaded = load_exported_serving_fn(out, device)
    x = torch.from_numpy(batch_from_mapping(
        generate_dataset(64, seed=9))).to(device)
    with torch.no_grad():
        got = loaded(x)
        saved = program.module()(x)
        want = (model.apply_quantiles(x) if model.quantiles else model(x))
    if not torch.equal(got, saved):
        raise SystemExit(f"{out}: the loaded program does not score as "
                         f"the program that was saved")
    tight = model.policy.compute_dtype == torch.float32
    rtol, atol = (1e-6, 1e-5) if tight else (2e-2, 0.25)
    got_np, want_np = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_allclose(got_np, want_np, rtol=rtol, atol=atol)
    log.info("exported", model=model_path, out=out, device=str(device),
             bytes=os.path.getsize(out), hidden=list(model.hidden),
             quantiles=list(model.quantiles),
             max_abs_err=float(np.max(np.abs(got_np - want_np))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
