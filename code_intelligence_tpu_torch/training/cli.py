"""LM training CLI of the port, on one card.

    python -m code_intelligence_tpu_torch.training.cli \
        --corpus_dir ./corpus --model_dir ./runs/lm \
        --bs 104 --bptt 67 --emb_sz 800 --n_hid 2500 --n_layers 4 --bf16

The JAX package's ``training/cli.py`` flags where they mean something on
one card, plus ``--device`` (``cuda`` unless ``cpu`` is asked for). The
corpus is what ``data.build_corpus`` writes (``train/`` and ``valid/``).
Written under ``--model_dir``: ``train_args.json``, checkpoints
(best-on-loss, ``ckpt/``), ``history.csv``, ``metrics.jsonl`` and
``encoder_export/``, which the port's server and the JAX engine load.
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

# flags of the JAX CLI that the port does not take yet, with the ROADMAP
# item that ports them; the mesh sizes are taken at 1 (one card is one
# device), and --flight_ring at 0 (no ring)
NOT_PORTED = {
    "seq_parallel": "queue 1 item 11, multi-GPU",
    "data_parallel": "queue 1 item 11, multi-GPU",
    "model_parallel": "queue 1 item 11, multi-GPU",
    "wandb_project": "queue 1 item 4, trackers",
    "wandb_mode": "queue 1 item 4, trackers",
    "metrics_port": "queue 1 item 4, device observability",
    "flight_ring": "queue 1 item 4, the flight recorder",
    "halt_on_divergence": "queue 1 item 4, the divergence sentinel",
}
NO_OP = {"seq_parallel": 1, "data_parallel": 1, "model_parallel": 1,
         "flight_ring": 0}

# the reference's dropouts (the JAX package's constants.BASE_DROPOUTS)
BASE_DROPOUTS = {"output_p": 0.1, "hidden_p": 0.15, "input_p": 0.25,
                 "embed_p": 0.02, "weight_p": 0.2}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--corpus_dir", required=True,
                   help="dir with train/ and valid/ corpora")
    p.add_argument("--model_dir", required=True,
                   help="output dir for checkpoints/logs")
    p.add_argument("--bs", type=int, default=104)
    p.add_argument("--bptt", type=int, default=67)
    p.add_argument("--emb_sz", type=int, default=800)
    p.add_argument("--n_hid", type=int, default=2500)
    p.add_argument("--n_layers", type=int, default=4)
    p.add_argument("--lr", type=float, default=1.3e-3)
    p.add_argument("--cycle_len", type=int, default=1)
    p.add_argument("--one_cycle", action="store_true", default=True)
    p.add_argument("--no_one_cycle", dest="one_cycle", action="store_false")
    p.add_argument("--lstm_pallas", action="store_true",
                   help="accepted for the JAX CLI's sake; the port always "
                        "runs its fused kernels on CUDA")
    for name, value in BASE_DROPOUTS.items():
        p.add_argument(f"--{name}", type=float, default=value)
    p.add_argument("--wd", type=float, default=0.01)
    p.add_argument("--grad_clip", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute, f32 master weights")
    p.add_argument("--max_tokens", type=int, default=None,
                   help="truncate each corpus (smoke runs)")
    p.add_argument("--early_stop_patience", type=int, default=2)
    p.add_argument("--steps_per_dispatch", type=int, default=20, metavar="K",
                   help="train K bptt windows between host reads of the "
                        "metrics")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--qrnn", action="store_true",
                   help="QRNN encoder (forget-mult kernels K6 and K7 on "
                        "CUDA)")
    p.add_argument("--qrnn_pallas", action="store_true",
                   help="implies --qrnn, as in the JAX CLI; the port always "
                        "runs its kernels on CUDA")
    for name in ("seq_parallel", "data_parallel", "model_parallel",
                 "metrics_port", "flight_ring"):
        p.add_argument(f"--{name}", type=int, default=None)
    p.add_argument("--wandb_project", default=None)
    p.add_argument("--wandb_mode", default=None)
    # either spelling exits: the port has no divergence sentinel
    p.add_argument("--halt_on_divergence", default=None,
                   action=argparse.BooleanOptionalAction)
    return p


def refuse_unported(args: argparse.Namespace) -> None:
    """Exit naming the ROADMAP item of any JAX flag the port does not
    take, unless its value asks for nothing (``NO_OP``)."""
    for name, item in NOT_PORTED.items():
        value = getattr(args, name)
        if value is not None and value != NO_OP.get(name):
            raise SystemExit(f"--{name} is not ported to the PyTorch "
                             f"package yet (ROADMAP.md {item})")


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    refuse_unported(args)
    if args.qrnn_pallas:
        args.qrnn = True  # the kernel flag implies the QRNN variant
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    log = logging.getLogger("train")

    from code_intelligence_tpu_torch.data import LMStreamLoader, TokenCorpus
    from code_intelligence_tpu_torch.models import AWDLSTMConfig
    from code_intelligence_tpu_torch.training import checkpoint as ckpt
    from code_intelligence_tpu_torch.training.callbacks import (
        CSVLogger,
        EarlyStopping,
        JSONLLogger,
        ReduceLROnPlateau,
        SaveBest,
    )
    from code_intelligence_tpu_torch.training.loop import (LMTrainer,
                                                           TrainConfig)

    corpus_dir = Path(args.corpus_dir)
    train_corpus = TokenCorpus(corpus_dir / "train")
    valid_corpus = TokenCorpus(corpus_dir / "valid")
    vocab = train_corpus.vocab
    log.info("corpus: %d train tokens, %d valid tokens, vocab %d",
             train_corpus.total_tokens, valid_corpus.total_tokens, len(vocab))

    def tokens(corpus):
        # stream() keeps the corpus mmap'd; only bounded runs materialize
        return (corpus.stream() if args.max_tokens is None
                else corpus.tokens(args.max_tokens))

    train_loader = LMStreamLoader(tokens(train_corpus), args.bs, args.bptt,
                                  seed=args.seed)
    valid_loader = LMStreamLoader(tokens(valid_corpus), args.bs, args.bptt,
                                  shuffle_offsets=False)

    mcfg = AWDLSTMConfig(
        vocab_size=len(vocab), emb_sz=args.emb_sz, n_hid=args.n_hid,
        n_layers=args.n_layers, pad_id=vocab.pad_id,
        lstm_use_pallas=args.lstm_pallas, qrnn=args.qrnn,
        qrnn_use_pallas=args.qrnn_pallas,
        dtype="bfloat16" if args.bf16 else "float32",
        **{name: getattr(args, name) for name in BASE_DROPOUTS})
    tcfg = TrainConfig(
        batch_size=args.bs, bptt=args.bptt, lr=args.lr,
        one_cycle=args.one_cycle, cycle_len=args.cycle_len, wd=args.wd,
        grad_clip=args.grad_clip, steps_per_dispatch=args.steps_per_dispatch)
    trainer = LMTrainer(mcfg, tcfg, steps_per_epoch=len(train_loader),
                        device=args.device)

    model_dir = Path(args.model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    (model_dir / "train_args.json").write_text(
        json.dumps(vars(args), default=str, indent=1))

    state = trainer.init_state(args.seed)
    if args.resume and ckpt.latest_step(model_dir / "ckpt") is not None:
        state = ckpt.restore_checkpoint(model_dir / "ckpt", state)
        log.info("resumed from step %d", state.step)

    callbacks = [
        EarlyStopping(patience=args.early_stop_patience),
        ReduceLROnPlateau(patience=1),
        SaveBest(model_dir / "ckpt"),
        CSVLogger(model_dir / "history.csv"),
        # every window: its metrics are on the host after each read anyway
        JSONLLogger(model_dir / "metrics.jsonl", every=1),
    ]
    state, history = trainer.fit(train_loader, valid_loader,
                                 epochs=args.cycle_len, callbacks=callbacks,
                                 state=state)

    enc_dir = ckpt.export_encoder(model_dir / "encoder_export",
                                  ckpt.encoder_arrays(state.model), mcfg,
                                  vocab)
    log.info("exported encoder to %s", enc_dir)
    summary = history[-1] if history else {}
    log.info("done: %s", summary)
    return summary


if __name__ == "__main__":
    main()
