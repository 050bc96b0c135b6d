"""The port's seq2seq (BASELINE config #3) vs the JAX package's, on the CPU.

* JAX's ``tests/test_seq2seq.py`` on the port: ``encode_pairs``' layout
  and truncation (equal to JAX's arrays), padding invariance, the
  pad-masked loss, a small model that learns reversal and translates
  held-out pairs, bf16 that trains;
* ``convert.seq2seq_from_jax``: the logits, the loss and every gradient of
  flax's model (2 layers, 16 units, ragged lengths and a fully padded
  row) at fp32 rtol 1e-5; greedy ``translate`` token-equal to JAX's; bf16
  logits and loss within 2e-2 of JAX's bf16;
* ``train_seq2seq.run`` at world 1 (this process) and world 2 (two gloo
  processes, ``tests/_torch_example_worker.py``) against the JAX example's
  recipe built in-process (``examples/seq2seq/seq2seq.py``'s pipeline on 1
  and 2 virtual devices, from the same flax weights; ``--unit 16 --layer
  2 --n-train 256 --epoch 2``): each epoch's loss at rtol 1e-4, the
  validation loss at rtol 1e-4, validation accuracy, the four
  translations and BLEU equal.
"""

import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

import chainermn_tpu as mn
from chainermn_tpu.iterators import SerialIterator as JaxSerialIterator
from chainermn_tpu.models import seq2seq as js
from chainermn_tpu_torch import train_seq2seq
from chainermn_tpu_torch.communicators import create_communicator
from chainermn_tpu_torch.convert import seq2seq_from_jax
from chainermn_tpu_torch.models.seq2seq import (BOS, EOS, N_SPECIAL, PAD,
                                                Seq2seq, encode_pairs,
                                                masked_cross_entropy,
                                                token_accuracy)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
from test_torch_model_parallel import launch_example  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch in one thread: the suite runs beside other test workers on the
    same cores, where a multi-threaded pool over the LSTM's small ops
    oversubscribes them (the 150-step training fixture took 660 s under
    the suite's 6 workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

VOCAB = 12
SRC_LEN = TGT_LEN = 8


def reversal_pairs(n, seed=0, min_len=2, max_len=6):
    rng = np.random.RandomState(seed)
    pairs = []
    for _ in range(n):
        k = rng.randint(min_len, max_len + 1)
        s = rng.randint(N_SPECIAL, VOCAB, size=k).tolist()
        pairs.append((s, s[::-1]))
    return pairs


def host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def flax_and_port(n_units=16, n_layers=2, dtype=jnp.float32, vocab=VOCAB,
                  seed=0):
    """A flax ``Seq2seq``, its params and the port's module loaded from
    them."""
    src0, tin0, _ = js.encode_pairs(reversal_pairs(2), SRC_LEN, TGT_LEN)
    jm = js.Seq2seq(vocab, vocab, n_units=n_units, n_layers=n_layers,
                    dtype=dtype)
    params = jm.init(jax.random.PRNGKey(seed), src0, tin0)
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tm = Seq2seq(vocab, vocab, n_units, n_layers, dtype=tdtype, device="cpu")
    seq2seq_from_jax(host(params), tm)
    return jm, params, tm


def ragged_batch():
    """Ragged pairs, an empty source and target, and a row longer than the
    bucket (truncated)."""
    pairs = reversal_pairs(5, seed=3) + [([], []), ([4] * 12, [5] * 12)]
    return encode_pairs(pairs, SRC_LEN, TGT_LEN)


def t(a):
    return torch.from_numpy(np.asarray(a))


class TestEncodePairs:
    def test_layout(self):
        src, tin, tout = encode_pairs([([5, 6], [6, 5])], 4, 4)
        assert src.tolist() == [[5, 6, PAD, PAD]]
        assert tin.tolist() == [[BOS, 6, 5, PAD]]
        assert tout.tolist() == [[6, 5, EOS, PAD]]

    def test_truncation(self):
        src, tin, tout = encode_pairs([([3] * 10, [4] * 10)], 4, 4)
        assert src.shape == (1, 4) and tin[0, 0] == BOS
        assert tout[0, -1] == EOS

    def test_equal_to_jax(self):
        pairs = reversal_pairs(9, seed=4) + [([], []), ([3] * 20, [4] * 20)]
        for got, want in zip(encode_pairs(pairs, 7, 9),
                             js.encode_pairs(pairs, 7, 9)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


class TestMaskedLoss:
    def test_padding_invariance(self):
        """More PAD in the bucket changes neither the loss nor the encoder
        state: the mask contract."""
        _, _, tm = flax_and_port(n_layers=1)
        pairs = reversal_pairs(4, seed=3)
        a = [t(x) for x in encode_pairs(pairs, SRC_LEN, TGT_LEN)]
        b = [t(x) for x in encode_pairs(pairs, SRC_LEN + 5, TGT_LEN + 5)]
        with torch.no_grad():
            la = masked_cross_entropy(tm(a[0], a[1]), a[2])
            lb = masked_cross_entropy(tm(b[0], b[1]), b[2])
            ca, cb = tm.encode(a[0]), tm.encode(b[0])
        np.testing.assert_allclose(float(la), float(lb), rtol=1e-5)
        for (c1, h1), (c2, h2) in zip(ca, cb):
            np.testing.assert_allclose(c1.numpy(), c2.numpy(), rtol=1e-6)
            np.testing.assert_allclose(h1.numpy(), h2.numpy(), rtol=1e-6)

    def test_loss_ignores_pad_targets(self):
        _, _, tm = flax_and_port(n_layers=1)
        src, tin, tout = (t(x) for x in ragged_batch())
        with torch.no_grad():
            logits = tm(src, tin)
        noise = torch.zeros_like(logits)
        noise[tout == PAD] = 100.0
        np.testing.assert_allclose(
            float(masked_cross_entropy(logits, tout)),
            float(masked_cross_entropy(logits + noise, tout)), rtol=1e-6)

    def test_accuracy_counts_non_pad_positions(self):
        tout = torch.tensor([[5, 6, EOS, PAD]])
        logits = torch.zeros(1, 4, 8)
        logits[0, 0, 5] = logits[0, 1, 3] = logits[0, 2, EOS] = 1.0
        logits[0, 3, 7] = 1.0
        assert float(token_accuracy(logits, tout)) == pytest.approx(2 / 3)


class TestAgainstFlax:
    def test_logits_loss_and_every_gradient(self):
        jm, params, tm = flax_and_port()
        src, tin, tout = ragged_batch()

        def loss_fn(p):
            return js.masked_cross_entropy(jm.apply(p, src, tin), tout)

        want_loss, want_grads = jax.value_and_grad(loss_fn)(params)
        want_logits = np.asarray(jm.apply(params, src, tin))
        logits = tm(t(src), t(tin))
        loss = masked_cross_entropy(logits, t(tout))
        loss.backward()
        np.testing.assert_allclose(logits.detach().numpy(), want_logits,
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
        flax_grads = Seq2seq(VOCAB, VOCAB, 16, 2, dtype=torch.float32,
                             device="cpu")
        seq2seq_from_jax(host(want_grads), flax_grads)
        want = dict(flax_grads.named_parameters())
        for name, p in tm.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), want[name].detach()
                                       .numpy(), rtol=1e-5, atol=1e-7,
                                       err_msg=name)

    def test_translate_is_token_equal(self):
        jm, params, tm = flax_and_port(seed=1)
        src, _, _ = ragged_batch()
        want = np.asarray(jm.apply(params, src, max_len=TGT_LEN + 2,
                                   method=js.Seq2seq.translate))
        got = tm.translate(t(src), max_len=TGT_LEN + 2).numpy()
        np.testing.assert_array_equal(got, want)

    def test_translate_emits_pad_after_eos(self):
        _, _, tm = flax_and_port()
        with torch.no_grad():
            tm.proj.bias[EOS] = 50.0
        toks = tm.translate(t(ragged_batch()[0]), max_len=5).numpy()
        assert (toks[:, 0] == EOS).all() and (toks[:, 1:] == PAD).all()

    def test_bf16_within_2e_2_of_jax_bf16(self):
        jm, params, tm = flax_and_port(dtype=jnp.bfloat16)
        src, tin, tout = ragged_batch()
        want = np.asarray(jm.apply(params, src, tin))
        with torch.no_grad():
            got = tm(t(src), t(tin))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-2,
                                   atol=2e-2)
        np.testing.assert_allclose(
            float(masked_cross_entropy(got, t(tout))),
            float(js.masked_cross_entropy(want, tout)), rtol=2e-2)

    def test_converter_refuses_a_mismatched_tree(self):
        _, params, _ = flax_and_port()
        with pytest.raises((KeyError, ValueError)):
            seq2seq_from_jax(host(params), Seq2seq(
                VOCAB, VOCAB, 16, 3, dtype=torch.float32, device="cpu"))
        with pytest.raises(ValueError):
            seq2seq_from_jax(host(params), Seq2seq(
                VOCAB, VOCAB, 8, 2, dtype=torch.float32, device="cpu"))


class TestSeq2seqTrains:
    @pytest.fixture(scope="class")
    def trained(self):
        """JAX's recipe on the port: 150 Adam steps of 64 reversal pairs
        from flax's initial weights, width 64."""
        _, _, tm = flax_and_port(n_units=64)
        opt = torch.optim.Adam(tm.parameters(), lr=3e-3)
        train = [t(a) for a in encode_pairs(reversal_pairs(512, seed=1),
                                            SRC_LEN, TGT_LEN)]
        rng = np.random.RandomState(0)
        accs = []
        for _ in range(150):
            idx = torch.from_numpy(rng.randint(0, 512, size=64))
            src, tin, tout = (a[idx] for a in train)
            logits = tm(src, tin)
            masked_cross_entropy(logits, tout).backward()
            opt.step()
            opt.zero_grad()
            accs.append(float(token_accuracy(logits, tout)))
        return tm, accs

    def test_accuracy_improves(self, trained):
        _, accs = trained
        assert np.mean(accs[-10:]) > 0.8, np.mean(accs[-10:])

    def test_greedy_translate_heldout(self, trained):
        tm, _ = trained
        pairs = reversal_pairs(16, seed=777)
        src, _, _ = encode_pairs(pairs, SRC_LEN, TGT_LEN)
        toks = tm.translate(t(src), max_len=TGT_LEN).numpy()
        hits = sum([x for x in toks[i] if x not in (PAD, EOS)] == tgt
                   for i, (_, tgt) in enumerate(pairs))
        assert hits >= 12, f"only {hits}/16 held-out reversals exact"


def test_bf16_traces_and_trains():
    """bf16 compute with fp32 parameters: fp32 logits, finite gradients,
    and a few Adam steps lower the loss."""
    tm = Seq2seq(10, 10, 16, 2, dtype=torch.bfloat16, device="cpu")
    src = torch.tensor([[4, 5, 6, 0], [7, 8, 0, 0]])
    tin = torch.tensor([[1, 6, 5, 4], [1, 8, 7, 0]])
    tout = torch.tensor([[6, 5, 4, 2], [8, 7, 2, 0]])
    assert tm(src, tin).dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    opt = torch.optim.Adam(tm.parameters(), lr=1e-2)
    losses = []
    for _ in range(10):
        loss = masked_cross_entropy(tm(src, tin), tout)
        loss.backward()
        assert all(bool(torch.isfinite(p.grad).all())
                   for p in tm.parameters())
        opt.step()
        opt.zero_grad()
        losses.append(float(loss))
    assert losses[-1] < losses[0]


def test_seq2seq_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        Seq2seq(10, 10)
    with pytest.raises(RuntimeError, match="cuda"):
        train_seq2seq.main(["--epoch", "1"])


# ---- the example against the JAX example ----

FLAGS = {"unit": 16, "layer": 2, "n_train": 256, "epoch": 2}
ARGV = ["--device", "cpu"] + [f"--{k.replace('_', '-')}={v}"
                              for k, v in FLAGS.items()]


def _jax_example_module():
    spec = importlib.util.spec_from_file_location(
        "jax_seq2seq_example", ROOT / "examples" / "seq2seq" / "seq2seq.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def jax_example(world, batchsize=64, bucket=12, vocab=32, lr=3e-3,
                n_val=256):
    """``examples/seq2seq/seq2seq.py``'s pipeline at ``world`` virtual
    devices: epoch losses, validation metrics, translations, BLEU and the
    initial flax params."""
    make_corpus = _jax_example_module().make_corpus
    comm = mn.create_communicator("xla", size=world)
    train_pairs = make_corpus(FLAGS["n_train"], vocab, seed=1)
    val_pairs = make_corpus(n_val, vocab, seed=2)
    scattered = mn.scatter_dataset(train_pairs, comm, shuffle=True, seed=0)
    model = js.Seq2seq(vocab, vocab, n_units=FLAGS["unit"],
                       n_layers=FLAGS["layer"], dtype=jnp.float32)
    src0, tin0, _ = js.encode_pairs(train_pairs[:2], bucket, bucket)
    params = model.init(jax.random.PRNGKey(0), src0, tin0)
    init = host(params)
    opt = mn.create_multi_node_optimizer(optax.adam(lr), comm)

    def loss_fn(p, batch):
        src, tin, tout = batch
        logits = model.apply(p, src, tin)
        return (js.masked_cross_entropy(logits, tout),
                js.token_accuracy(logits, tout))

    step = mn.make_train_step(loss_fn, opt, mesh=comm.mesh, has_aux=True,
                              donate=False)
    flat = [shard[i] for r in range(comm.size)
            for shard in [scattered.shard(r)] for i in range(len(shard))]
    it = JaxSerialIterator(flat, batchsize, shuffle=True, seed=0)
    state = opt.init(params)
    epochs = []
    for _ in range(FLAGS["epoch"]):
        losses = []
        for _ in range(len(flat) // batchsize):
            batch = mn.shard_batch(js.encode_pairs(it.next(), bucket, bucket),
                                   comm.mesh)
            params, state, loss, _ = step(params, state, batch)
            losses.append(float(loss))
        epochs.append(np.mean(losses))
    vsrc, vtin, vtout = js.encode_pairs(val_pairs, bucket, bucket)
    logits = model.apply(params, vsrc, vtin)

    def translate_fn(srcs):
        arr, _, _ = js.encode_pairs([(list(s), list(s)) for s in srcs],
                                    bucket, bucket)
        out = np.asarray(model.apply(params, arr, max_len=bucket,
                                     method=js.Seq2seq.translate))
        return [[int(x) for x in row if x not in (PAD, EOS)] for row in out]

    hyps = translate_fn([s for s, _ in val_pairs[:4]])
    return {"epoch_losses": epochs,
            "validation/loss": float(js.masked_cross_entropy(logits, vtout)),
            "validation/accuracy": float(js.token_accuracy(logits, vtout)),
            "translations": [(list(s), h) for (s, _), h in
                             zip(val_pairs[:4], hyps)],
            "bleu": mn.bleu_evaluator(translate_fn, comm)([val_pairs])["bleu"],
            "init": init}


@pytest.fixture(scope="module")
def jax_runs():
    return {w: jax_example(w) for w in (1, 2)}


def _assert_example(result, want, world):
    assert result["world"] == world and result["dtype"] == "float32"
    assert result["iterations"] == FLAGS["epoch"] * FLAGS["n_train"] // 64
    np.testing.assert_allclose(result["epoch_losses"], want["epoch_losses"],
                               rtol=1e-4)
    np.testing.assert_allclose(result["validation/loss"],
                               want["validation/loss"], rtol=1e-4)
    assert result["validation/accuracy"] == pytest.approx(
        want["validation/accuracy"], abs=1e-7)
    assert [tuple(map(list, p)) for p in result["translations"]] == \
        [tuple(p) for p in want["translations"]]
    assert result["bleu"] == pytest.approx(want["bleu"], abs=1e-12)
    assert result["epoch_losses"][-1] < result["epoch_losses"][0]


def test_example_world_1_matches_jax(jax_runs, tmp_path):
    create_communicator("xla", device="cpu")
    try:
        result, _ = train_seq2seq.run(ARGV + ["--out", str(tmp_path)],
                                      params=jax_runs[1]["init"])
    finally:
        dist.destroy_process_group()
    _assert_example(result, jax_runs[1], 1)


def test_example_world_2_gloo_matches_jax(jax_runs, tmp_path):
    outs, logs = launch_example("seq2seq", 2, tmp_path, jax_runs[2]["init"],
                                ARGV)
    for out in outs:
        _assert_example(out, jax_runs[2], 2)
    assert "validation BLEU" in logs[0] and "validation BLEU" not in logs[1]


def test_example_refuses_the_naive_communicator(capsys):
    with pytest.raises(SystemExit):
        train_seq2seq.run(["--device", "cpu", "--communicator", "naive"])
    assert "naive" in capsys.readouterr().err
