"""Multi-host integration tests: 2 processes x 4 virtual CPU devices with a
local TCP coordinator must match the single-process 8-device run.

The reference is single-node shared-memory only (SURVEY.md §2.4 final row);
multi-host bring-up (jax.distributed + per-process batch feeding) is this
framework's own north-star axis (BASELINE: 1->N host scaling).  These
tests prove the FULL gang path — process bring-up, gloo collectives,
make_array_from_process_local_data feeding, lead-process logging — is
numerically identical to one process owning the whole mesh.

Subprocess-heavy (each worker pays its own jax import + compile), so the
suite keeps the step counts tiny.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "mp_worker.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _clean_env(n_local_devices: int) -> dict:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count="
                        f"{n_local_devices}")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run_gang(cmds, n_local_devices, timeout=420):
    """Launch one subprocess per command, wait for all, fail with captured
    output if any dies."""
    procs = [subprocess.Popen(c, env=_clean_env(n_local_devices),
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0, (f"rank {i} exited {rc}\n--- stdout ---\n{out}\n"
                         f"--- stderr ---\n{err[-4000:]}")
    return outs


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("mode", ["sharded", "hybrid"])
def test_two_process_matches_single_process(mode, tmp_path):
    """Library-level gang parity: same steps, same data, 1 proc x 8 dev vs
    2 proc x 4 dev (+ hybrid 2x4 DCNxICI mesh where DCN = the process
    boundary), final params compared elementwise."""
    single = str(tmp_path / "single.npz")
    multi = str(tmp_path / "multi.npz")
    _run_gang([[sys.executable, WORKER, "--pid", "0", "--nproc", "1",
                "--port", "0", "--mode", mode, "--out", single]], 8)
    port = str(_free_port())
    _run_gang([[sys.executable, WORKER, "--pid", str(i), "--nproc", "2",
                "--port", port, "--mode", mode, "--out", multi]
               for i in range(2)], 4)
    ref, got = _load(single), _load(multi)
    assert set(ref) == set(got)
    worst = 0.0
    for k in ref:
        diff = float(np.max(np.abs(ref[k].astype(np.float64)
                                   - got[k].astype(np.float64))))
        worst = max(worst, diff)
        # cross-process gloo reductions may order sums differently from
        # the in-process XLA reduction: ulp-level slack, nothing more
        np.testing.assert_allclose(ref[k], got[k], rtol=2e-6, atol=2e-6,
                                   err_msg=k)
    assert worst < 2e-6


def test_cli_distributed_train(tmp_path):
    """End-to-end CLI gang: `python -m dlrm_tpu train --distributed` on 2
    processes must train, eval (global metric reduction), and have ONLY
    process 0 print the result JSON; its final loss must match the
    single-process CLI run."""
    # --platform cpu forces the virtual CPU mesh whatever accelerator the
    # machine has
    args = ["-m", "dlrm_tpu", "train", "--config", "tiny", "--platform",
            "cpu", "--steps", "4", "--batch-size", "64", "--log-every",
            "2", "--eval-after", "--eval-steps", "2", "--seed", "3",
            "--update-interval", "2"]

    single = _run_gang([[sys.executable] + args], 8)
    port = _free_port()
    dist = ["--distributed", "--coordinator", f"127.0.0.1:{port}",
            "--num-processes", "2"]
    multi = _run_gang([[sys.executable] + args + dist
                       + ["--process-id", str(i)] for i in range(2)], 4)

    def _payload_lines(out):  # drop gloo's own connection chatter
        return [l for l in out.strip().splitlines()
                if l and not l.startswith("[Gloo]")]

    ref = json.loads(_payload_lines(single[0][1])[-1])
    # lead process prints the result; rank 1 must print nothing of its own
    assert _payload_lines(multi[1][1]) == [], multi[1][1]
    got = json.loads(_payload_lines(multi[0][1])[-1])
    assert got["steps"] == ref["steps"] == 4
    assert np.isclose(got["final_loss"], ref["final_loss"],
                      rtol=2e-5, atol=2e-6)
    for key in ("accuracy", "auc", "loss"):
        assert np.isclose(got["eval"][key], ref["eval"][key],
                          rtol=2e-5, atol=2e-5), key
    assert got["eval"]["examples"] == ref["eval"]["examples"]
