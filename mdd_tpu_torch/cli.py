"""Command-line interface of the port (counterpart of mdd_tpu/cli.py).

  python -m mdd_tpu_torch train --conf YAML [--resume] [--device cuda|cpu]
  python -m mdd_tpu_torch evaluate --conf YAML [--checkpoint DIR]
                                [--dump-dir DIR] [--decode-type Greedy|Beam]
                                [--lm-alpha A] [--cached] [--device cuda|cpu]
  python -m mdd_tpu_torch mdd-result --ref F --human F --hyp F
                                [--detail-dir DIR]
  python -m mdd_tpu_torch train-lm --phn-text F --out ARPA
  python -m mdd_tpu_torch serve --conf YAML --cmvn F [--checkpoint DIR]
                                [--device cuda|cpu] [--decode-type Greedy|Beam]

`train` runs the recipe of the YAML, on the device-resident corpus where
it says `device_cache: true` (train and dev split) and on the streaming
loader otherwise, and writes `best` and the resumable `latest` under
`<checkpoint_dir>/<exp_name>/`.  `evaluate` decodes the YAML's test split
with `best` (greedy, or the batched beam with the bigram LM of `lm_path`
weighted by `lm_alpha`), prints PER and the TA/FR/FA/TR report and, with
`--dump-dir`, writes the decode_seq / human_seq / transcribe files that
`mdd-result` scores; `--cached` puts the test split on the device first.
`train-lm` trains that bigram LM from a phone transcript file.
`serve` answers line-delimited JSON requests on stdin (see serve.py).
The checkpoint is the port's format (train/checkpoint.py): by default
`<checkpoint_dir>/<exp_name>/best.pt` + `best.meta.json` of the config.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional


def _build_loader(cfg, vocab, scp, lab, trans, train: bool,
                  device: str = "cuda"):
    """mdd_tpu's `_build_loader` in one process: the device-resident corpus
    on `device` where the config says `device_cache`, else the streaming
    loader."""
    from mdd_tpu_torch.data.dataset import BucketedLoader, SpeechDataset
    from mdd_tpu_torch.data.prefetch import ThreadedLoader

    ds = SpeechDataset(
        vocab, scp, lab, trans,
        left_ctx=cfg.left_ctx, right_ctx=cfg.right_ctx,
        n_skip_frame=cfg.n_skip_frame, n_downsample=cfg.n_downsample,
        train=train, augment_mode=cfg.augment_mode,
        mutation_prob=cfg.mutation_prob,
        device_frontend=cfg.device_frontend)
    if cfg.device_frontend and cfg.device_cache:
        from mdd_tpu_torch.data.device_cache import (CachedLoader,
                                                     DeviceFeatureCache)

        # the streaming branch's wire dtype (unset: float32), so both
        # paths give one config the same features
        cache = DeviceFeatureCache(ds, device, time_quantum=cfg.time_quantum,
                                   wire_dtype=cfg.wire_dtype or "float32")
        return CachedLoader(cache, cfg.batch_size,
                            shuffle=train and cfg.shuffle_train,
                            seed=cfg.seed, label_quantum=cfg.label_quantum)
    loader = BucketedLoader(
        ds, cfg.batch_size, shuffle=train and cfg.shuffle_train,
        seed=cfg.seed, num_workers=cfg.num_workers,
        time_quantum=cfg.time_quantum, label_quantum=cfg.label_quantum,
        wire_dtype=(cfg.wire_dtype or None) if cfg.device_frontend else None)
    if cfg.num_workers > 0:
        loader = ThreadedLoader(loader, prefetch=4)
    return loader


def build_trainer(cfg, vocab, device: str, **model_overrides):
    """The Trainer of the YAML's recipe.  `model_overrides` replace
    ModelConfig fields no YAML key sets (`use_fused_dropout`, as in
    mdd_tpu, where it is reached through ModelConfig only)."""
    import dataclasses

    from mdd_tpu_torch.train.loop import Trainer

    return Trainer(
        dataclasses.replace(cfg.model_config(vocab.n_words),
                            **model_overrides),
        init_lr=cfg.init_lr, weight_decay=cfg.weight_decay,
        lr_decay=cfg.lr_decay, end_adjust_acc=cfg.end_adjust_acc,
        plateau_patience=cfg.plateau_patience,
        max_adjust_times=cfg.max_adjust_times, seed=cfg.seed,
        device=device, device_frontend=cfg.device_frontend,
        left_ctx=cfg.left_ctx, right_ctx=cfg.right_ctx,
        n_skip_frame=cfg.n_skip_frame, n_downsample=cfg.n_downsample)


def cmd_train(args) -> int:
    from mdd_tpu_torch.data.vocab import Vocab
    from mdd_tpu_torch.utils.config import check_train_config, load_config

    cfg = load_config(args.conf)
    check_train_config(cfg)
    vocab = Vocab.from_units_file(cfg.vocab_file)
    print(f"Vocabulary size is {vocab.n_words}")
    trainer = build_trainer(cfg, vocab, args.device)
    train_loader = _build_loader(cfg, vocab, cfg.train_scp_path,
                                 cfg.train_lab_path, cfg.train_trans_path,
                                 train=True, device=args.device)
    dev_loader = _build_loader(cfg, vocab, cfg.valid_scp_path,
                               cfg.valid_lab_path, cfg.valid_trans_path,
                               train=False, device=args.device)
    summary = trainer.fit(train_loader, dev_loader,
                          num_epochs=cfg.num_epoches,
                          print_every=cfg.verbose_step,
                          checkpoint_dir=cfg.checkpoint_dir,
                          exp_name=cfg.exp_name, resume=args.resume,
                          checkpoint_every=cfg.checkpoint_every)
    print("best dev loss %.4f acc %.4f after %d epochs"
          % (summary["best_dev_loss"], summary["best_acc"],
             summary["epochs"]))
    return 0


def cmd_train_lm(args) -> int:
    from mdd_tpu_torch.decode.lm_train import train_phone_lm

    n = train_phone_lm(args.phn_text, args.out)
    print(f"trained bigram LM on {n} sentences -> {args.out}")
    return 0


def _load_best(cfg, checkpoint: Optional[str]):
    """-> (state_dict, ModelConfig) of the experiment's `best`."""
    from mdd_tpu_torch.models.ctc_model import model_config_from_meta
    from mdd_tpu_torch.train.checkpoint import load_checkpoint

    ckpt_dir = checkpoint or os.path.join(cfg.checkpoint_dir, cfg.exp_name)
    state, meta = load_checkpoint(ckpt_dir, "best")
    return state, model_config_from_meta(meta)


def cmd_evaluate(args) -> int:
    from mdd_tpu_torch.data.vocab import Vocab
    from mdd_tpu_torch.evals.evaluate import EvalSession, evaluate_model
    from mdd_tpu_torch.utils.config import load_config

    if args.distributed:
        raise SystemExit(
            "evaluate --distributed is not ported yet: multi-process "
            "evaluation comes with the port's scale-out slice (ROADMAP.md); "
            "run without it")
    cfg = load_config(args.conf)
    # `--cached` is opt-in, not inferred from the YAML's device_cache: a
    # one-shot evaluation pays the upload before the first batch, where
    # the streaming loader overlaps reading and decoding
    if args.cached and not cfg.device_frontend:
        raise SystemExit("evaluate --cached requires device_frontend: true "
                         "in the config")
    cfg.device_cache = args.cached
    if args.decode_type:
        cfg.decode_type = args.decode_type
    if args.lm_alpha is not None:
        cfg.lm_alpha = args.lm_alpha
    vocab = Vocab.from_units_file(cfg.vocab_file)
    state, model_cfg = _load_best(cfg, args.checkpoint)
    # device-frontend eval: raw bf16 features on the wire, splice/skip on
    # the device before the forward, as in training
    session = EvalSession(
        model_cfg, state, vocab, decode_type=cfg.decode_type,
        beam_width=cfg.beam_width, lm_path=cfg.lm_path or None,
        lm_alpha=cfg.lm_alpha, device=args.device,
        device_frontend=cfg.device_frontend,
        left_ctx=cfg.left_ctx, right_ctx=cfg.right_ctx,
        n_skip_frame=cfg.n_skip_frame, n_downsample=cfg.n_downsample)
    loader = _build_loader(cfg, vocab, cfg.test_scp_path, cfg.test_lab_path,
                           cfg.test_trans_path, train=False,
                           device=args.device)
    if args.cached:
        session.attach_cache(loader.cache)
    evaluate_model(session, loader, dump_dir=args.dump_dir)
    return 0


def cmd_mdd_result(args) -> int:
    """Score decode dumps: the result/mdd_result.sh:6-13 pipeline
    (compute-wer PER report + 3-way hierarchical MDD analysis) over trn
    files as produced by `evaluate --dump-dir`."""
    from mdd_tpu_torch.evals.analysis import mdd_result
    from mdd_tpu_torch.evals.wer import read_trn

    mdd_result(read_trn(args.ref), read_trn(args.human),
               read_trn(args.hyp), out_dir=args.detail_dir)
    return 0


def _build_engine(args):
    from mdd_tpu_torch.data.vocab import Vocab
    from mdd_tpu_torch.frontend.cmvn import parse_kaldi_cmvn_text
    from mdd_tpu_torch.infer import InferenceEngine
    from mdd_tpu_torch.utils.config import load_config

    cfg = load_config(args.conf)
    if args.decode_type:
        cfg.decode_type = args.decode_type
    state, model_cfg = _load_best(cfg, args.checkpoint)
    return InferenceEngine(
        model_cfg, state,
        Vocab.from_units_file(cfg.vocab_file),
        cmvn=parse_kaldi_cmvn_text(args.cmvn),
        decode_type=cfg.decode_type, beam_width=cfg.beam_width,
        lm_path=cfg.lm_path or None, lm_alpha=cfg.lm_alpha,
        left_ctx=cfg.left_ctx, right_ctx=cfg.right_ctx,
        n_skip_frame=cfg.n_skip_frame, n_downsample=cfg.n_downsample,
        device=args.device)


def cmd_serve(args) -> int:
    """Load the model once, answer JSON request lines on stdin until EOF."""
    from mdd_tpu_torch.serve import serve_loop

    engine = _build_engine(args)
    log = (None if args.quiet else
           (lambda m: print(m, file=sys.stderr, flush=True)))
    print("ready", file=sys.stderr, flush=True)
    n = serve_loop(engine, sys.stdin, sys.stdout, log=log)
    print(f"served {n} requests in {engine.session.forwards} forwards",
          file=sys.stderr)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="mdd_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    q = sub.add_parser("train", help="train the CTC-attention model")
    q.add_argument("--conf", required=True)
    q.add_argument("--resume", action="store_true",
                   help="continue from the experiment's 'latest' "
                        "checkpoint (params, optimizer, LR scheduler and "
                        "loss histories are restored)")
    q.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda)")
    q.set_defaults(fn=cmd_train)

    q = sub.add_parser("evaluate", help="MDD evaluation on the test set")
    q.add_argument("--conf", required=True)
    q.add_argument("--checkpoint",
                   help="directory holding best.pt + best.meta.json "
                        "(default: <checkpoint_dir>/<exp_name>)")
    q.add_argument("--dump-dir",
                   help="write decode_seq.log, human_seq.log and "
                        "transcribe.log here (mdd-result's inputs)")
    q.add_argument("--decode-type", dest="decode_type",
                   help="override the config's decode_type (e.g. Greedy "
                        "vs Beam for ablation runs)")
    q.add_argument("--lm-alpha", dest="lm_alpha", type=float,
                   help="override the config's LM fusion weight "
                        "(0 disables the LM term in the beam)")
    q.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")
    q.add_argument("--cached", action="store_true",
                   help="put the test split's features on the device "
                        "first and form each batch there (needs "
                        "device_frontend)")
    q.add_argument("--distributed", action="store_true",
                   help="not ported yet (scale-out slice): refused")
    q.set_defaults(fn=cmd_evaluate)

    q = sub.add_parser("mdd-result",
                       help="score decode dumps (mdd_result.sh pipeline)")
    q.add_argument("--ref", required=True,
                   help="canonical phones trn (transcribe.log)")
    q.add_argument("--human", required=True,
                   help="human-annotated phones trn (human_seq.log)")
    q.add_argument("--hyp", required=True,
                   help="decoded phones trn (decode_seq.log)")
    q.add_argument("--detail-dir",
                   help="emit Kaldi-format *_detail alignment files here")
    q.set_defaults(fn=cmd_mdd_result)

    q = sub.add_parser("train-lm", help="train bigram phone LM")
    q.add_argument("--phn-text", required=True)
    q.add_argument("--out", required=True)
    q.set_defaults(fn=cmd_train_lm)

    q = sub.add_parser("serve", help="persistent diagnosis server "
                                     "(line-delimited JSON on stdin)")
    q.add_argument("--conf", required=True)
    q.add_argument("--checkpoint",
                   help="directory holding best.pt + best.meta.json "
                        "(default: <checkpoint_dir>/<exp_name>)")
    q.add_argument("--cmvn", required=True)
    q.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")
    q.add_argument("--decode-type", dest="decode_type",
                   help="override the config's decode_type (Greedy, or "
                        "anything else for the beam)")
    q.add_argument("--quiet", action="store_true",
                   help="no per-request log lines on stderr")
    q.set_defaults(fn=cmd_serve)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
