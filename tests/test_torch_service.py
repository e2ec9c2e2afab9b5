"""The port's continuous FL service as a process: SIGTERM mid-campaign
finishes the round, checkpoints and exits 0; ``--resume`` runs to the end
with a contiguous history equal to an uninterrupted run's."""
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np

from repro_torch.fl import experiment as exp
from repro_torch.fl.history import History
from repro_torch.testing import pin_cpu_threads, thread_env

pin_cpu_threads()

SRC = str(Path(__file__).resolve().parents[1] / "src")
SPEC = {
    "data": {"name": "by_class_shards",
             "options": {"clients_per_class": 2, "train_per_client": 40, "dim": 8,
                         "n_classes": 4, "seed": 0}},
    "sampler": {"name": "algorithm2", "m": 4, "seed": 3},
    "train": {"n_rounds": 10, "n_local_steps": 3, "batch_size": 10, "seed": 1,
              "checkpoint_every": 2},
    "population": {"name": "poisson", "options": {"join_rate": 0.3, "leave_rate": 0.3}},
    "scheduler": {"name": "deadline", "options": {"straggle_frac": 0.3},
                  "track_availability": True},
}


def _service(tmp_path, *extra):
    cmd = [sys.executable, "-m", "repro_torch.launch.fl_service", "--device", "cpu",
           "--spec", json.dumps(SPEC), "--checkpoint", str(tmp_path / "svc.npz"),
           "--history", str(tmp_path / "history.json"), *extra]
    env = thread_env({**os.environ, "PYTHONPATH": SRC + os.pathsep + os.environ.get("PYTHONPATH", "")})
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def test_service_survives_sigterm_and_resumes(tmp_path):
    proc = _service(tmp_path, "--throttle", "0.3")
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if sum(ln.startswith("[round ") for ln in lines) == 3:
                proc.send_signal(signal.SIGTERM)
                break
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    lines += out.splitlines(keepends=True)
    assert proc.returncode == 0, err
    assert any(ln.startswith("stop requested") for ln in lines), lines
    first = History.from_json((tmp_path / "history.json").read_text())
    cut = len(first.records)
    assert 3 <= cut < SPEC["train"]["n_rounds"]

    proc = _service(tmp_path, "--resume")
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err
    assert f"resuming at round {cut}" in out
    resumed = History.from_json((tmp_path / "history.json").read_text())
    assert [r.round for r in resumed.records] == list(range(SPEC["train"]["n_rounds"]))
    with exp.build_experiment(SPEC, device="cpu") as srv:
        want = srv.run()
    for g, w in zip(resumed.records, want.records):
        np.testing.assert_array_equal(g.agg_weights, w.agg_weights)
        assert (g.n_late, g.n_harvested, g.round_status) == (w.n_late, w.n_harvested, w.round_status)
        assert g.train_loss == w.train_loss or (np.isnan(g.train_loss) and np.isnan(w.train_loss))
    # without --device the service asks for the card and raises here
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.fl_service", "--spec",
                           json.dumps(SPEC), "--checkpoint", str(tmp_path / "x.npz")],
                          capture_output=True, text=True, timeout=120,
                          env=thread_env({**os.environ, "PYTHONPATH": SRC}))
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr
