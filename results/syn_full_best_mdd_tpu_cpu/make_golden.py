"""Write mdd_tpu's own decode of the regenerated syn_full test split with
the committed checkpoint `checkpoints/syn_full/best`, on the CPU.

The corpus is the one the checkpoint was trained on (easy profile,
16-40 phones, the reference's 41 units):

    python tools/synthetic_corpus.py data/synthetic_full 0 0 900 \
        --min-phones 16 --max-phones 40 \
        --units results/synthetic_full_hard_torch/units

(the test split has its own seed, so `0 0 900` writes the same test
files as `5496 897 900`).  Then, from the repo root:

    python results/syn_full_best_mdd_tpu_cpu/make_golden.py \
        data/synthetic_full results/syn_full_best_mdd_tpu_cpu

decodes it as `python -m mdd_tpu.cli evaluate --conf
conf/synthetic_full.yaml --checkpoint checkpoints/syn_full` would (beam
10, no LM, batch 256, the bf16 wire), with the plain LSTM scan in place
of the Pallas kernel, as bench.py does off the TPU, and writes the
report to `eval.log` and the dumps beside it.
"""

import dataclasses
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from mdd_tpu.cli import _build_loader, _model_config_from_meta  # noqa: E402
from mdd_tpu.data.vocab import Vocab  # noqa: E402
from mdd_tpu.evals.evaluate import EvalSession, evaluate_model  # noqa: E402
from mdd_tpu.train.checkpoint import load_checkpoint  # noqa: E402
from mdd_tpu.utils.config import load_config  # noqa: E402


def main(corpus: str, out: str) -> None:
    cfg = load_config(os.path.join(ROOT, "conf", "synthetic_full.yaml"))
    cfg.vocab_file = os.path.join(corpus, "units")
    cfg.test_scp_path = os.path.join(corpus, "test.scp")
    cfg.test_lab_path = os.path.join(corpus, "test_phn_text")
    cfg.test_trans_path = os.path.join(corpus, "test_transcript_phn_text")
    vocab = Vocab.from_units_file(cfg.vocab_file)
    state, meta = load_checkpoint(os.path.join(ROOT, "checkpoints",
                                               "syn_full"), "best")
    model_cfg = dataclasses.replace(_model_config_from_meta(meta),
                                    use_pallas_lstm=False)
    session = EvalSession(
        model_cfg, {"params": state["params"],
                    "batch_stats": state["batch_stats"]}, vocab,
        decode_type=cfg.decode_type, beam_width=cfg.beam_width,
        lm_path=cfg.lm_path or None, lm_alpha=cfg.lm_alpha,
        device_frontend=cfg.device_frontend, left_ctx=cfg.left_ctx,
        right_ctx=cfg.right_ctx, n_skip_frame=cfg.n_skip_frame,
        n_downsample=cfg.n_downsample)
    loader = _build_loader(cfg, vocab, cfg.test_scp_path, cfg.test_lab_path,
                           cfg.test_trans_path, train=False,
                           device_fe=cfg.device_frontend, mesh=session.mesh,
                           allow_cache=False)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "eval.log"), "w", encoding="utf-8") as f:
        def log(*parts):
            line = " ".join(str(p) for p in parts)
            print(line)
            f.write(line + "\n")

        evaluate_model(session, loader, dump_dir=out, log=log)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
