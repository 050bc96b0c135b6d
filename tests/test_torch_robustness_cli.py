"""The port's demo CLI with its robustness flags against JAX's (CPU, no card).

(``train_mnist_checkpoint`` is held to the JAX example in
``tests/test_torch_mnist_checkpoint.py``.)

* ``python -m chainermn_tpu_torch.train`` with ``--checkpoint-dir``,
  ``--preemption-grace-s``, ``--self-heal``, ``--watchdog-timeout`` and
  ``--flight-dump-dir`` against JAX's CLI trajectory on the same seeds,
  every iteration's loss at rtol 1e-4; then SIGTERM mid-run: exit 0, a
  ``preempt`` bundle naming the saved generation, and a rerun that resumes
  to the uninterrupted run's final loss;
* ``--metrics-out`` and ``--statusz-port``, both ported: the metrics
  stream validates and the run serves /statusz.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from chainermn_tpu_torch import train
from chainermn_tpu_torch.observability.flight import (find_bundles,
                                                      read_bundle)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
from test_torch_trainer import _jax_demo_run  # noqa: E402

def _run_cli(argv, tmp_path, timeout=120):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.Popen(
        [sys.executable, "-m", "chainermn_tpu_torch.train", "--device",
         "cpu", *argv], cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def test_demo_cli_robustness_flags_match_jax(tmp_path):
    """Every robustness flag on, 10 steps, a log entry a step: the JAX
    CLI's per-iteration losses; the result carries ``self_heal``; a clean
    run's finalize removes its checkpoints (as JAX's does)."""
    want_losses, _, _ = _jax_demo_run(1)
    p = _run_cli(["--steps", "10", "--log-every", "1", "--checkpoint-dir",
                  "ck", "--checkpoint-every", "3", "--preemption-grace-s",
                  "30", "--self-heal", "--self-heal-min-world", "1",
                  "--self-heal-beat-s", "0.05", "--watchdog-timeout", "60",
                  "--flight-dump-dir", "dump", "--out", "out"], tmp_path)
    out, err = p.communicate(timeout=120)
    assert p.returncode == 0, err[-3000:]
    result = json.loads(out.strip().splitlines()[-1])
    assert result["steps"] == 10 and result["world"] == 1
    assert result["self_heal"]["world"] == 1
    assert result["self_heal"]["rank_lost_events"] == 0
    log = json.loads((tmp_path / "out" / "log").read_text())
    np.testing.assert_allclose([e["main/loss"] for e in log], want_losses,
                               rtol=1e-4)
    assert os.listdir(tmp_path / "ck") == []


def test_demo_cli_sigterm_saves_exits_0_and_resumes(tmp_path):
    """SIGTERM once the first generation is on disk: a final save at the
    next step boundary, a ``preempt`` bundle naming it, exit 0; the rerun
    resumes from it to the uninterrupted run's final loss."""
    steps = ["--steps", "60", "--log-every", "20", "--checkpoint-every",
             "1"]
    full = _run_cli(steps + ["--out", "full"], tmp_path)   # beside it
    argv = steps + ["--checkpoint-dir", "ck", "--preemption-grace-s", "30",
                    "--self-heal", "--flight-dump-dir", "dump", "--out",
                    "run"]
    p = _run_cli(argv, tmp_path)
    deadline = time.monotonic() + 60
    while not any(".proc0of1" in f for f in
                  (os.listdir(tmp_path / "ck")
                   if (tmp_path / "ck").exists() else [])):
        assert p.poll() is None and time.monotonic() < deadline, \
            p.communicate()[1][-3000:]
        time.sleep(0.005)
    p.send_signal(signal.SIGTERM)
    out, err = p.communicate(timeout=60)
    assert p.returncode == 0, err[-3000:]
    assert "SIGTERM received" in err
    (bundle,) = [b for b in find_bundles(str(tmp_path / "dump"))
                 if b.endswith("-preempt")]
    pre = read_bundle(bundle)["manifest"]["extra"]["preempt"]
    saved = pre["generation_saved"]
    assert isinstance(saved, int) and 0 < saved < 60
    assert pre["why_not_saved"] is None and pre["world_size"] == 1
    assert any(f".iter{saved:012d}.proc0of1" in f
               for f in os.listdir(tmp_path / "ck"))

    again = _run_cli(argv, tmp_path)
    fout, ferr = full.communicate(timeout=120)
    assert full.returncode == 0, ferr[-3000:]
    want = json.loads(fout.strip().splitlines()[-1])["final_loss"]
    out, err = again.communicate(timeout=120)
    assert again.returncode == 0, err[-3000:]
    assert f"resumed from generation {saved}" in err
    result = json.loads(out.strip().splitlines()[-1])
    assert result["steps"] == 60
    np.testing.assert_allclose(result["final_loss"], want, rtol=1e-6)


@pytest.mark.parametrize("flag,value", [("--metrics-out", "m.jsonl"),
                                        ("--statusz-port", "0")])
def test_observability_flags_still_refused(flag, value, capsys, tmp_path):
    """Both flags are ported (the name is kept from when they were
    refused): ``--metrics-out`` writes a stream that validates, with a
    step record an iteration, the summary and the skew report, and a
    ``.prom`` that parses; ``--statusz-port`` serves /statusz and
    reports the bound port."""
    if flag == "--statusz-port":
        assert train.main(["--device", "cpu", "--steps", "2", "--out",
                           str(tmp_path), flag, value]) == 0
        result = json.loads(capsys.readouterr().out.strip()
                            .splitlines()[-1])
        assert isinstance(result["statusz_port"], int)
        assert result["statusz_port"] > 0 and result["steps"] == 2
        return
    from chainermn_tpu_torch.observability.export import (
        parse_prometheus_text, read_metrics_jsonl)
    path = tmp_path / value
    assert train.main(["--device", "cpu", "--steps", "2", "--out",
                       str(tmp_path), flag, str(path)]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["steps"] == 2 and result["straggler_rank"] == 0
    kinds = [r["kind"] for r in read_metrics_jsonl(str(path), strict=True)]
    assert kinds == ["step", "step", "summary", "skew_report"]
    assert parse_prometheus_text(open(f"{path}.prom").read())["samples"]
