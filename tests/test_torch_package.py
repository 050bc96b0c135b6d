"""Package hygiene of chainermn_tpu_torch, the npz converter and the CLI.

* No module of the port, and not ``chip_smoke.py``, imports ``jax`` or the
  JAX package (``chainermn_tpu``, as distinct from ``chainermn_tpu_torch``).
* Serving through the port in a fresh process leaves ``jax`` out of
  ``sys.modules``.
* Entry points default to ``device="cuda"`` and raise where there is no
  card instead of running on the CPU.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from chainermn_tpu.parallel import init_tp_transformer_lm as jax_init
from chainermn_tpu_torch import convert
from chainermn_tpu_torch.parallel import init_tp_transformer_lm
from chainermn_tpu_torch.serving import ServingEngine

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "chainermn_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "scripts" / "profile_torch_serving.py",
    ROOT / "scripts" / "profile_torch_train.py",
    ROOT / "scripts" / "profile_torch_resnet.py",
    ROOT / "tests" / "_torch_dp_worker.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(module):
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "chainermn_tpu")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_rule_tells_the_packages_apart():
    assert _forbidden("chainermn_tpu.serving") and _forbidden("jax.numpy")
    assert not _forbidden("chainermn_tpu_torch.serving")


def test_serving_subprocess_never_loads_jax():
    code = (
        "import sys, json\n"
        "from chainermn_tpu_torch.serve import main\n"
        "main(['--device', 'cpu', '--requests', '3', '--max-new-tokens', "
        "'3'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'chainermn_tpu'))\n"
        "print(json.dumps({'bad': bad}))\n")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    summary = json.loads(lines[-2])
    assert summary["schema"] == "chainermn_tpu.serve.v1"
    assert [r["status"] for r in summary["requests"]] == ["done"] * 3
    assert json.loads(lines[-1]) == {"bad": []}


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")


def test_entry_points_default_to_cuda_and_raise_without_it():
    _no_card()
    with pytest.raises(RuntimeError, match="cuda"):
        init_tp_transformer_lm(0, 64, 32, 4, 2)
    params = init_tp_transformer_lm(0, 64, 32, 4, 2, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(params, head_dim=8)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.from_jax({"w": np.zeros(2, np.float32)})
    from chainermn_tpu_torch.serve import main
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--requests", "1"])
    from chainermn_tpu_torch.train_transformer import main as train_main
    with pytest.raises(RuntimeError, match="cuda"):
        train_main(["--steps", "1"])


def test_dp_entry_points_default_to_cuda_and_raise_without_it():
    _no_card()
    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.models import ARCHS
    from chainermn_tpu_torch.train_imagenet import main as imagenet_main
    with pytest.raises(RuntimeError, match="cuda"):
        create_communicator()
    with pytest.raises(RuntimeError, match="cuda"):
        ARCHS["resnet18"]()
    with pytest.raises(RuntimeError, match="cuda"):
        imagenet_main(["--arch", "resnet18", "--steps", "1"])


@pytest.mark.parametrize("argv", [
    ["--arch", "nf_resnet50"], ["--arch", "vit_s16"], ["--fsdp"],
    ["--norm", "stalebn"], ["--optimizer", "lars"], ["--agc", "0.01"],
    ["--allreduce-grad-dtype", "int8"]])
def test_imagenet_cli_refuses_unported_paths(argv, capsys):
    from chainermn_tpu_torch.train_imagenet import main
    with pytest.raises(SystemExit):
        main(["--device", "cpu", *argv])
    assert "ROADMAP.md" in capsys.readouterr().err


def test_imagenet_cli_trains_from_a_data_dir_without_jax(tmp_path):
    """``train_imagenet`` on the CPU: writes the synthetic records to
    ``--data-dir``, trains ResNet-18 with the pallas conv backward over a
    one-rank gloo group and prints the loss and throughput; ``jax`` stays
    out of ``sys.modules``."""
    code = (
        "import sys, json\n"
        "from chainermn_tpu_torch.train_imagenet import main\n"
        "main(['--device', 'cpu', '--arch', 'resnet18', '--image-size', "
        "'32', '--batchsize', '4', '--steps', '2', '--dataset-size', '16', "
        "'--num-classes', '10', '--conv-impl', 'pallas', '--data-dir', "
        f"{str(tmp_path / 'data')!r}])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'chainermn_tpu'))\n"
        "print(json.dumps({'bad': bad}))\n")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("resnet18  cards=1  global_batch=4")
    assert lines[1].startswith("materialized 16 records")
    assert lines[-3].startswith("loss ") and "throughput:" in lines[-2]
    assert json.loads(lines[-1]) == {"bad": []}
    assert (tmp_path / "data" / "meta.json").exists()


def test_cli_trains_then_serves(capsys):
    """``serve --train-steps 60`` (the default): the JAX CLI's recipe
    trains the toy LM, the loss falls, and the trained model serves."""
    from chainermn_tpu_torch.serve import main
    assert main(["--device", "cpu", "--train-steps", "60",
                 "--requests", "4"]) == 0
    out, err = capsys.readouterr()
    losses = [float(line.split()[-1]) for line in err.splitlines()
              if line.startswith("train step")]
    assert len(losses) == 3 and losses[-1] < 0.5 * losses[0]
    summary = json.loads(out.strip().splitlines()[-1])
    assert [r["status"] for r in summary["requests"]] == ["done"] * 4
    assert summary["mean_continuation_accuracy"] > 0.5


def test_train_transformer_cli(capsys):
    from chainermn_tpu_torch.train_transformer import main
    assert main(["--device", "cpu", "--steps", "20", "--attn-impl", "flash",
                 "--ce-impl", "fused"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    first = float(lines[1].split()[2])
    last = float(lines[-1].split()[-1])
    assert lines[1].startswith("initial loss") and "step 20" in lines[2]
    assert last < first


def test_cli_summary_in_process(capsys):
    from chainermn_tpu_torch.serve import main
    assert main(["--device", "cpu", "--requests", "5", "--n-slots", "2",
                 "--pos-impl", "rope", "--stagger-every", "1"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["status"] for r in summary["requests"]] == ["done"] * 5
    assert summary["metrics"]["serving/tokens_total"] == 5 * 8


def test_cli_serves_gqa_sampled(capsys):
    """``--kv-heads`` and ``--temperature``: request ``i`` samples with
    ``fold_in(PRNGKey(seed + 1), i)``, so a rerun draws the same tokens."""
    from chainermn_tpu_torch.serve import main

    argv = ["--device", "cpu", "--train-steps", "0", "--requests", "3",
            "--kv-heads", "2", "--temperature", "0.8"]
    runs = []
    for _ in range(2):
        assert main(argv) == 0
        summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert [r["status"] for r in summary["requests"]] == ["done"] * 3
        runs.append([(r["n_tokens"], r["continuation_accuracy"])
                     for r in summary["requests"]])
    assert runs[0] == runs[1]


def test_from_jax_keeps_structure_values_and_bf16():
    import jax.numpy as jnp

    jp = jax_init(jax.random.PRNGKey(0), 16, 8, 2, 2, max_len=8,
                  dtype=jnp.bfloat16)
    host = jax.tree_util.tree_map(np.asarray, jp)
    tp = convert.from_jax(host, device="cpu")
    assert isinstance(tp["blocks"], list) and len(tp["blocks"]) == 2
    w = tp["blocks"][1]["attn"]["wqkv"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w.float().numpy(), np.asarray(host["blocks"][1]["attn"]["wqkv"],
                                      np.float32))
    f32 = convert.from_jax(host, device="cpu", dtype=torch.float32)
    assert f32["embed"].dtype == torch.float32


def test_npz_round_trip_flat_keys(tmp_path):
    params = init_tp_transformer_lm(1, 16, 8, 2, 2, max_len=8,
                                    dtype=torch.bfloat16, device="cpu")
    path = str(tmp_path / "p.npz")
    convert.save_npz(path, params)
    with np.load(path) as z:
        assert "blocks.0.attn.wqkv" in z.files and "pos_embed" in z.files
    back = convert.load_npz(path, device="cpu")
    flat, flat_back = convert.flatten(params), convert.flatten(back)
    assert flat.keys() == flat_back.keys()
    for k in flat:
        assert flat_back[k].dtype == flat[k].dtype
        assert torch.equal(flat_back[k], flat[k]), k
    assert isinstance(back["blocks"], list)


def test_cli_serves_npz_params(tmp_path, capsys):
    from chainermn_tpu_torch.serve import main

    params = init_tp_transformer_lm(2, 64, 32, 4, 2, max_len=32, device="cpu")
    path = str(tmp_path / "p.npz")
    convert.save_npz(path, params)
    assert main(["--device", "cpu", "--params", path, "--requests", "2"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["status"] for r in summary["requests"]] == ["done"] * 2


def test_smoke_fails_without_a_card(tmp_path):
    """``chip_smoke.py`` exits non-zero and prints no result line where
    there is no card, and alone in a directory without the package."""
    _no_card()
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, lone)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
