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
    ROOT / "scripts" / "sweep_torch_ce.py",
    ROOT / "tests" / "_torch_dp_worker.py",
    ROOT / "tests" / "_torch_comm_worker.py",
    ROOT / "tests" / "_torch_trainer_worker.py",
    ROOT / "tests" / "_torch_functions_worker.py",
    ROOT / "tests" / "_torch_example_worker.py",
    ROOT / "tests" / "_torch_zero_worker.py"]
# the communicator and Trainer slice: each must be among PORT_FILES
TRAINER_SLICE = ["communicators/base.py", "communicators/naive.py",
                 "communicators/torch_dist.py", "ops/collective.py",
                 "observability/trace.py", "training/__init__.py",
                 "training/triggers.py", "training/trainer.py",
                 "training/updaters.py", "training/extensions.py",
                 "iterators/__init__.py", "evaluators.py",
                 "extensions/__init__.py",
                 "extensions/observation_aggregator.py", "train.py",
                 "train_mnist.py", "convert.py"]
# the model-parallel and seq2seq slice: each must be among PORT_FILES
MODEL_PARALLEL_SLICE = ["__init__.py", "functions/__init__.py",
                        "functions/collective.py",
                        "functions/point_to_point.py",
                        "functions/pseudo_connect.py", "links/__init__.py",
                        "links/multi_node_chain_list.py",
                        "links/multi_node_batch_normalization.py",
                        "extensions/allreduce_persistent.py",
                        "models/seq2seq.py", "train_seq2seq.py",
                        "train_model_parallel.py", "ops/__init__.py",
                        "communicators/__init__.py"]


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


@pytest.mark.parametrize("module", TRAINER_SLICE + MODEL_PARALLEL_SLICE)
def test_trainer_slice_modules_are_checked(module):
    assert ROOT / "chainermn_tpu_torch" / module in PORT_FILES


def test_trainer_subprocess_never_loads_jax(tmp_path):
    code = (
        "import sys, json\n"
        "from chainermn_tpu_torch import train, train_mnist\n"
        f"train.main(['--device', 'cpu', '--steps', '2', '--out', "
        f"{str(tmp_path / 'a')!r}])\n"
        "train_mnist.main(['--device', 'cpu', '--unit', '8', '--n-train', "
        f"'256', '--n-val', '32', '--epoch', '1', '--out', "
        f"{str(tmp_path / 'b')!r}])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'chainermn_tpu'))\n"
        "print(json.dumps({'bad': bad}))\n")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {"bad": []}


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


def test_build_key_follows_the_included_headers(tmp_path):
    """An edit to a ``csrc/*.cuh`` that a source includes gives the source
    a new library path; an unrelated header leaves it alone."""
    from chainermn_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cuh").write_text("#pragma once\n#include \"b.cuh\"\n")
    (csrc / "b.cuh").write_text("#pragma once\n// b\n")
    (csrc / "other.cuh").write_text("// unrelated\n")
    (csrc / "k.cu").write_text("#include <cuda.h>\n#include \"a.cuh\"\n")
    before = _build._lib_path("k", csrc)
    assert [p.name for p in _build._sources("k", csrc)] == [
        "k.cu", "a.cuh", "b.cuh"]
    (csrc / "other.cuh").write_text("// edited\n")
    assert _build._lib_path("k", csrc) == before
    (csrc / "b.cuh").write_text("#pragma once\n// b, edited\n")
    after = _build._lib_path("k", csrc)
    assert after != before and after.name.startswith("libk-")
    # the shipped sources that include the shared header are keyed by it
    for name in ("fused_ce", "flash_fwd", "conv_backward"):
        assert "hopper.cuh" in [p.name for p in _build._sources(
            name, _build._CSRC)]


@pytest.mark.parametrize("shape,width,padded", [
    ((4, 16), None, False), ((4, 12), 16, True), ((2, 3, 3, 12), 16, True),
    ((2, 3, 3, 16), 16, False)])
@pytest.mark.parametrize("offset", [0, 1])
def test_tma_operand_pads_and_copies_only_when_needed(shape, width, padded,
                                                      offset):
    """The TMA kernels' operands: a 16-byte-aligned input of the right
    width is passed as it is; a narrower one gains zero columns, a
    misaligned one (``offset`` elements past an aligned base) is copied."""
    from chainermn_tpu_torch.ops._build import tma_operand

    n = int(np.prod(shape))
    x = torch.empty(n + offset, dtype=torch.bfloat16)[offset:].view(shape)
    x.copy_(torch.randn(shape))
    assert (x.data_ptr() % 16 == 0) == (offset == 0)
    got = tma_operand(x, width)
    want = width or shape[-1]
    assert got.shape == shape[:-1] + (want,) and got.data_ptr() % 16 == 0
    assert (got is x) == (offset == 0 and not padded)
    assert torch.equal(got[..., :shape[-1]], x)
    assert not got[..., shape[-1]:].any()


# ---- the package's public face (JAX's top-level names) ----

def _jax_top_level_names():
    """Every public name ``chainermn_tpu/__init__.py`` binds."""
    tree = ast.parse((ROOT / "chainermn_tpu" / "__init__.py").read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level == 1:
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    return sorted(n for n in names if not n.startswith("_")
                  or n == "__version__")


@pytest.mark.parametrize("name", _jax_top_level_names())
def test_every_jax_top_level_name_resolves_or_is_listed(name):
    """Each of JAX's top-level names resolves on ``import
    chainermn_tpu_torch as mn``, or is in the one table of names not yet
    ported beside its ROADMAP.md queue item, and then raises naming it."""
    import re

    import chainermn_tpu_torch as mn

    if name in mn.NOT_PORTED:
        assert re.fullmatch(r"A\d+", mn.NOT_PORTED[name])
        with pytest.raises(AttributeError,
                           match=f"ROADMAP.md, queue A, "
                                 f"{mn.NOT_PORTED[name]}"):
            getattr(mn, name)
    else:
        assert getattr(mn, name) is not None


def test_not_ported_table_holds_only_jax_names():
    import chainermn_tpu_torch as mn

    assert set(mn.NOT_PORTED) <= set(_jax_top_level_names())


def test_unknown_name_raises_attribute_error():
    import chainermn_tpu_torch as mn

    with pytest.raises(AttributeError, match="no attribute"):
        mn.no_such_name
    assert not hasattr(mn, "no_such_name")


def test_chainermn_face_resolves_to_the_submodules():
    import chainermn_tpu_torch as mn
    from chainermn_tpu_torch import (communicators, datasets, evaluators,
                                     optimizers, train)

    assert mn.create_communicator is communicators.create_communicator
    assert mn.create_multi_node_optimizer is \
        optimizers.create_multi_node_optimizer
    assert mn.scatter_dataset is datasets.scatter_dataset
    assert mn.make_train_step is train.make_train_step
    assert mn.create_multi_node_evaluator is \
        evaluators.create_multi_node_evaluator
    assert mn.functions.send is not None and mn.links.MultiNodeChainList
    assert "create_communicator" in dir(mn)


def test_importing_the_package_imports_no_submodule():
    code = ("import sys, json\n"
            "import chainermn_tpu_torch as mn\n"
            "before = sorted(m for m in sys.modules if m.startswith("
            "'chainermn_tpu_torch'))\n"
            "mn.create_communicator\n"
            "after = 'chainermn_tpu_torch.communicators' in sys.modules\n"
            "print(json.dumps([before, after]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    before, after = json.loads(out.stdout.strip().splitlines()[-1])
    assert before == ["chainermn_tpu_torch"] and after


def test_ops_reexports_the_in_step_collectives():
    """JAX's ``ops`` exports its collectives; the port's resolves each to
    ``ops.collective``, the int8 ring's and the hierarchical mean's too."""
    import chainermn_tpu.ops as jops

    from chainermn_tpu_torch import ops
    from chainermn_tpu_torch.ops import collective

    jax_names = {n for n in dir(jops) if not n.startswith("_")
                 and n in dir(__import__("chainermn_tpu.ops.collective",
                                         fromlist=["x"]))
                 and callable(getattr(jops, n))}
    for name in jax_names:
        assert getattr(ops, name) is getattr(collective, name), name
    assert {"psum", "pmean", "pmax", "pmin", "all_gather", "all_to_all",
            "ppermute", "shift", "axis_index", "axis_size", "bcast"} <= \
        set(ops.COLLECTIVES)


def test_renamed_classes_keep_their_jax_names():
    import chainermn_tpu_torch as mn
    from chainermn_tpu_torch.communicators import TorchDistCommunicator
    from chainermn_tpu_torch.training import extensions

    assert extensions.JaxProfiler is extensions.TorchProfiler
    assert mn.XlaCommunicator is TorchDistCommunicator


def test_new_clis_never_load_jax(tmp_path):
    """``train_seq2seq`` and ``train_imagenet --arch resnet152
    --double-buffering`` (one timed step after the warm-up at image 32,
    batch 2) on the CPU, with ``jax`` out of ``sys.modules``."""
    code = (
        "import sys, json\n"
        "from chainermn_tpu_torch import train_imagenet, train_seq2seq\n"
        "r, _ = train_seq2seq.run(['--device', 'cpu', '--unit', '8', "
        "'--n-train', '128', '--n-val', '16', '--epoch', '1', '--out', "
        f"{str(tmp_path / 's2s')!r}])\n"
        "train_imagenet.main(['--device', 'cpu', '--arch', 'resnet152', "
        "'--double-buffering', '--image-size', '32', '--batchsize', '2', "
        "'--steps', '1', '--dataset-size', '4', '--num-classes', '10'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'chainermn_tpu'))\n"
        "print(json.dumps({'bad': bad, 'iterations': r['iterations']}))\n")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["OMP_NUM_THREADS"] = "1"     # beside other test workers
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert any(line.startswith("resnet152  cards=1  global_batch=2")
               for line in lines)
    assert lines[-3].startswith("loss ") and "throughput:" in lines[-2]
    assert json.loads(lines[-1]) == {"bad": [], "iterations": 2}
