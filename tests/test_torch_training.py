"""The port's LM training slice against the JAX package: one window's loss
and gradients (dropout off, and with the same masks injected on both
sides), three AdamW windows against optax, the schedules, the stream
loader, checkpoint resume, and the CLI end to end on the CPU.

The JAX side runs ``LMTrainer`` on a one-device mesh with the Pallas LSTM
branch (``lstm_use_pallas=True``, interpret mode on the CPU), the
``custom_vjp`` that the port's K4/K5 Function mirrors. No JAX slot or
ragged scheduler is built here."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import code_intelligence_tpu.models.awd_lstm as jax_awd
from code_intelligence_tpu.data import LMStreamLoader as JaxLoader
from code_intelligence_tpu.data import TokenCorpus as JaxCorpus
from code_intelligence_tpu.models import AWDLSTMConfig as JaxConfig
from code_intelligence_tpu.parallel import make_mesh
from code_intelligence_tpu.training import LMTrainer as JaxTrainer
from code_intelligence_tpu.training import TrainConfig as JaxTrainConfig
from code_intelligence_tpu.training import schedules as jax_schedules
from code_intelligence_tpu_torch.data import (
    LMStreamLoader,
    TokenCorpus,
    build_corpus,
)
from code_intelligence_tpu_torch.models import AWDLSTMConfig, AWDLSTMLM
from code_intelligence_tpu_torch.training import (
    LMTrainer,
    TrainConfig,
    schedules,
)
from code_intelligence_tpu_torch.training import checkpoint as ckpt

# f32 throughout. Loss, CE and the carried states: the JAX suite's bar.
# Gradients are sums over B*T positions (and, for the embedding, over the
# tied decoder's V columns), taken in another order on each side.
ATOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
# Parameters after three AdamW updates: each update is at most ~lr (2.6e-3
# at the one-cycle peak) and depends on the gradients only through
# mu / sqrt(nu), so the gradient differences above move a parameter by far
# less than this.
PARAM_ATOL = 1e-6

SIZES = dict(vocab_size=40, emb_sz=8, n_hid=12, n_layers=3)
B, T = 3, 6
NO_DROPOUT = dict(output_p=0.0, hidden_p=0.0, input_p=0.0, embed_p=0.0,
                  weight_p=0.0)
# nonzero rates; embed_p is raised from the reference's 0.02 so that a
# 40-row table drops some rows
DROPOUT = dict(output_p=0.1, hidden_p=0.15, input_p=0.25, embed_p=0.2,
               weight_p=0.2)


def _jax_trainer(rates, **train):
    cfg = JaxConfig(**SIZES, **rates, lstm_use_pallas=True)
    mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
    return JaxTrainer(cfg, JaxTrainConfig(batch_size=B, bptt=T, **train),
                      mesh=mesh, steps_per_epoch=10)


def _port_model(rates, jax_params):
    model = AWDLSTMLM(AWDLSTMConfig(**SIZES, **rates))
    model.load_state_dict(ckpt.lm_params_from_jax(jax.device_get(jax_params)))
    return model


def _window(seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, SIZES["vocab_size"], (B, T + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _states(seed=1):
    """Nonzero carried (h, c) per layer, f32 numpy."""
    rng = np.random.default_rng(seed)
    cfg = JaxConfig(**SIZES)
    return [tuple(rng.normal(0, 0.3, (B, cfg.layer_size(li))).astype(
        np.float32) for _ in range(2)) for li in range(cfg.n_layers)]


def _masks(rates, seed=2):
    """Boolean keep masks for every dropout site, from numpy."""
    rng = np.random.default_rng(seed)
    cfg = JaxConfig(**SIZES)

    def keep(p, *shape):
        return rng.random(shape) < 1 - p

    masks = {"embed": keep(rates["embed_p"], cfg.vocab_size, 1),
             "input": keep(rates["input_p"], B, 1, cfg.emb_sz),
             "output": keep(rates["output_p"], B, 1, cfg.emb_sz)}
    for li in range(cfg.n_layers):
        H = cfg.layer_size(li)
        masks[f"weight_{li}"] = keep(rates["weight_p"], 4 * H, H)
        if li < cfg.n_layers - 1:
            masks[f"hidden_{li}"] = keep(rates["hidden_p"], B, 1, H)
    return masks


def _inject_jax_masks(monkeypatch, masks):
    """Serve the masks to the JAX model in call order: its bernoulli draws
    (embedding rows, then each layer's DropConnect) and its locked masks
    (input, each hidden, output). The fixture undoes both patches."""
    n = SIZES["n_layers"]
    bern = [masks["embed"]] + [masks[f"weight_{li}"] for li in range(n)]
    locked = ([masks["input"]] + [masks[f"hidden_{li}"]
                                  for li in range(n - 1)] + [masks["output"]])

    def fake_bernoulli(key, p, shape):
        keep = bern.pop(0)
        assert keep.shape == tuple(shape)
        return jnp.asarray(keep)

    def fake_locked(rng, p, shape, dtype):
        keep = locked.pop(0)
        assert keep.shape == tuple(shape)
        return jnp.asarray(keep).astype(dtype) / (1.0 - p)

    monkeypatch.setattr(jax_awd, "_locked_dropout_mask", fake_locked)
    monkeypatch.setattr(jax.random, "bernoulli", fake_bernoulli)
    return bern, locked


@pytest.mark.parametrize("rates", [NO_DROPOUT, DROPOUT],
                         ids=["dropout0", "injected_masks"])
def test_window_loss_and_grads_match_jax(monkeypatch, rates):
    jtrainer = _jax_trainer(rates)
    params = jtrainer.init_state(jax.random.PRNGKey(0)).params
    x, y = _window()
    states = _states()
    masks = _masks(rates) if rates is DROPOUT else {}
    if masks:
        queues = _inject_jax_masks(monkeypatch, masks)
    (want_loss, (want_states, want_ce, want_acc)), want_grads = \
        jax.value_and_grad(jtrainer._loss, has_aux=True)(
            params, jnp.asarray(x), jnp.asarray(y),
            tuple((jnp.asarray(h), jnp.asarray(c)) for h, c in states),
            jax.random.PRNGKey(1))
    if masks:
        assert queues == ([], [])  # every injected mask was used

    model = _port_model(rates, params)
    ptrainer = LMTrainer(model.config, TrainConfig(batch_size=B, bptt=T),
                         device="cpu")
    t = torch.from_numpy
    loss, (new_states, ce, acc) = ptrainer.loss(
        model, t(x).long(), t(y).long(),
        tuple((t(h), t(c)) for h, c in states),
        {k: t(v) for k, v in masks.items()})
    loss.backward()

    np.testing.assert_allclose(loss.item(), float(want_loss), atol=ATOL)
    np.testing.assert_allclose(ce.item(), float(want_ce), atol=ATOL)
    assert acc.item() == pytest.approx(float(want_acc))
    for (h, c), (wh, wc) in zip(new_states, want_states):
        np.testing.assert_allclose(h.detach().numpy(), np.asarray(wh),
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(c.detach().numpy(), np.asarray(wc),
                                   atol=ATOL, rtol=0)
    want = ckpt.lm_params_from_jax(jax.device_get(want_grads))
    got = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)


def test_three_adamw_windows_match_optax():
    # one-cycle over 10 steps (lr and b1 both move), weight decay, and a
    # clip between the windows' gradient norms (~0.28, ~0.28, ~0.22), so
    # both sides of it run
    train = dict(wd=0.1, grad_clip=0.25)
    jtrainer = _jax_trainer(NO_DROPOUT, **train)
    jstate = jtrainer.init_state(jax.random.PRNGKey(0))
    params0 = jax.device_get(jstate.params)
    ptrainer = LMTrainer(AWDLSTMConfig(**SIZES, **NO_DROPOUT),
                         TrainConfig(batch_size=B, bptt=T, **train),
                         steps_per_epoch=10, device="cpu")
    pstate = ptrainer.init_state(0, batch_size=B)
    pstate.model.load_state_dict(ckpt.lm_params_from_jax(params0))
    clipped = 0
    for step in range(3):
        x, y = _window(seed=10 + step)
        jstate, jm = jtrainer.train_step(jstate, x, y)
        pstate, pm = ptrainer.train_step(pstate, x, y)
        assert pm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
        np.testing.assert_allclose(pm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-5)
        clipped += float(jm["grad_norm"]) > train["grad_clip"]
    assert clipped == 2 and pstate.step == 3
    want = ckpt.lm_params_from_jax(jax.device_get(jstate.params))
    start = ckpt.lm_params_from_jax(params0)
    for name, p in pstate.model.state_dict().items():
        assert not torch.equal(p, start[name]), name  # the update moved it
        np.testing.assert_allclose(p.numpy(), want[name].numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("total,pct", [(10, 0.3), (2, 0.3), (37, 0.25)])
def test_schedules_match_optax(total, pct):
    """The JAX package's schedules are optax's (cosine_onecycle_schedule,
    and its momentum cycle in jnp). They compute in f32, the port in
    Python floats: they agree to f32 precision of the schedule's peak."""
    peak = 2.6e-3
    for port, ref, scale in (
            (schedules.one_cycle_lr(total, peak, pct_start=pct),
             jax_schedules.one_cycle_lr(total, peak, pct_start=pct), peak),
            (schedules.one_cycle_momentum(total, 0.85, 0.95, pct_start=pct),
             jax_schedules.one_cycle_momentum(total, 0.85, 0.95,
                                              pct_start=pct), 0.95)):
        for step in range(max(total, 4) + 3):
            assert port(step) == pytest.approx(float(ref(step)), rel=1e-6,
                                               abs=1e-6 * scale)
    assert schedules.constant(0.5)(7) == 0.5


def _texts(n=120, seed=0):
    rng = np.random.default_rng(seed)
    words = ("pipeline notebook kubeflow katib tfjob pod crash error when "
             "running the operator fails with timeout").split()
    return [" ".join(rng.choice(words, rng.integers(3, 30)))
            for _ in range(n)]


def test_corpus_and_loader_match_jax(tmp_path):
    """A corpus the port writes reads the same through the JAX package's
    TokenCorpus, and both loaders cut the same windows, offsets and
    seeded epoch rotations from it."""
    train, _ = build_corpus(_texts(), tmp_path, min_freq=1,
                            shard_size_tokens=500)
    assert len(train.shard_files) > 1
    jtrain = JaxCorpus(tmp_path / "train")
    assert jtrain.vocab.itos == train.vocab.itos
    np.testing.assert_array_equal(jtrain.tokens(), train.tokens())
    for kw in ({"seed": 3}, {"shuffle_offsets": False}):
        port = LMStreamLoader(train.stream(), 4, 7, **kw)
        ref = JaxLoader(jtrain.stream(), 4, 7, **kw)
        assert len(port) == len(ref) and port.tokens_per_epoch == \
            ref.tokens_per_epoch
        for epoch in range(3):
            for (x, y), (wx, wy) in zip(port.epoch(epoch), ref.epoch(epoch)):
                np.testing.assert_array_equal(x, wx)
                np.testing.assert_array_equal(y, wy)


def test_resumed_run_equals_uninterrupted(tmp_path):
    """Two windows, a checkpoint, a fresh state restored from it and two
    more windows give what four windows in a row give: parameters, Adam
    moments, carried states and the dropout generator."""
    cfg = AWDLSTMConfig(**SIZES, **DROPOUT)
    trainer = LMTrainer(cfg, TrainConfig(batch_size=B, bptt=T),
                        steps_per_epoch=10, device="cpu")
    windows = [_window(seed=20 + i) for i in range(4)]
    straight = trainer.init_state(5, batch_size=B)
    for x, y in windows:
        straight, _ = trainer.train_step(straight, x, y)

    first = trainer.init_state(5, batch_size=B)
    for x, y in windows[:2]:
        first, _ = trainer.train_step(first, x, y)
    first.lr_scale = 0.5
    ckpt.save_checkpoint(tmp_path, first)
    assert ckpt.latest_step(tmp_path) == 2
    resumed = ckpt.restore_checkpoint(tmp_path,
                                      trainer.init_state(9, batch_size=B))
    assert resumed.step == 2 and resumed.lr_scale == 0.5
    resumed.lr_scale = 1.0
    for x, y in windows[2:]:
        resumed, _ = trainer.train_step(resumed, x, y)

    for (n, p), q in zip(straight.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert torch.equal(p, q), n
    for n, m in straight.opt_state.items():
        for k in ("mu", "nu"):
            assert torch.equal(m[k], resumed.opt_state[n][k]), (n, k)
    for s, r in zip(straight.lstm_states, resumed.lstm_states):
        assert torch.equal(s[0], r[0]) and torch.equal(s[1], r[1])
    assert torch.equal(straight.generator.get_state(),
                       resumed.generator.get_state())


def test_cli_trains_on_cpu_and_the_engine_serves_the_export(tmp_path):
    from code_intelligence_tpu_torch.inference.engine import InferenceEngine
    from code_intelligence_tpu_torch.training.cli import main

    build_corpus(_texts(300), tmp_path / "corpus", min_freq=1)
    model_dir = tmp_path / "run"
    args = ["--corpus_dir", str(tmp_path / "corpus"), "--model_dir",
            str(model_dir), "--device", "cpu", "--bs", "4", "--bptt", "8",
            "--emb_sz", "8", "--n_hid", "12", "--n_layers", "2",
            "--steps_per_dispatch", "3", "--lr", "1e-2"]
    summary = main(args)
    assert np.isfinite(summary["loss"]) and np.isfinite(summary["val_loss"])
    step = ckpt.latest_step(model_dir / "ckpt")
    assert step is not None and step > 0
    assert json.loads((model_dir / "train_args.json").read_text())[
        "device"] == "cpu"
    history = (model_dir / "history.csv").read_text().splitlines()
    assert len(history) == 2 and "val_loss" in history[0]

    export = model_dir / "encoder_export"
    engine = InferenceEngine.from_export(export, device="cpu")
    vec = engine.embed_issue("Katib trial crash", "pipeline error when running")
    assert vec.shape == (3 * 8,) and vec.dtype == np.float32
    assert np.isfinite(vec).all()

    # a resumed run starts from the checkpoint's step
    summary2 = main(args + ["--resume"])
    assert ckpt.latest_step(model_dir / "ckpt") >= step
    assert np.isfinite(summary2["loss"])

    # QRNN is ported: the flag trains
    qrnn = main(args + ["--qrnn", "--model_dir", str(tmp_path / "qrnn")])
    assert np.isfinite(qrnn["loss"]) and np.isfinite(qrnn["val_loss"])
    with pytest.raises(SystemExit, match="not ported"):
        main(args + ["--data_parallel", "2"])


@pytest.mark.parametrize("flags,item", [
    (["--model_parallel", "1", "--seq_parallel", "1", "--data_parallel",
      "1"], None),
    (["--model_parallel", "2"], "11"),
    (["--seq_parallel", "2"], "11"),
    (["--halt_on_divergence"], "4"),
    (["--no-halt_on_divergence"], "4")])
def test_cli_takes_one_device_flags_and_names_the_item_of_others(flags, item):
    """The JAX CLI's own mesh defaults (1) mean one device and pass; any
    other mesh size, and either spelling of the divergence flag, exit
    naming their ROADMAP item."""
    from code_intelligence_tpu.training.cli import build_parser as jax_parser
    from code_intelligence_tpu_torch.training import cli

    required = ["--corpus_dir", "c", "--model_dir", "m"]
    jax_args = jax_parser().parse_args(required)
    assert (jax_args.model_parallel, jax_args.seq_parallel) == (1, 1)
    args = cli.build_parser().parse_args(required + flags)
    if item is None:
        cli.refuse_unported(args)
    else:
        with pytest.raises(SystemExit, match=f"queue 1 item {item},"):
            cli.refuse_unported(args)
