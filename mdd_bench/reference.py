"""The plain reference of a training cell, in plain PyTorch and NumPy.

It imports nothing of the program.  From the benchmark's corpus, the
configuration file, the mix and the seed it works out again everything the
timed path derives:

* the batches: the raw-length buckets, each epoch's permutation and batch
  shuffle, each item's SpecAugment geometry and canonical-transcript
  mutation (the recipe's `augment_mode` 2), the rows padded to the batch
  size, the label widths, the bfloat16 wire, the masks, the context splice
  and frame skip;
* the model: the forward of the configuration's family
  (`families/<family>.py`, through `manifest.family`), which builds on the
  shared parts here: masked BatchNorm (the statistics of the real rows
  only) and the ranks' dropout;
* the dropout masks, drawn as the recipe draws them: `torch.rand` of each
  site's shape from a Generator on the run's device seeded
  (seed + 1) mod 2**32, in the order of the forward;
* the CTC loss (torch's, in float64) over the family's CTC input sizes,
  its mean over the real rows, the gradients (autograd) and Adam with
  coupled L2 weight decay.

It runs in float32 with TF32 off.  `precision="fp8"` is the control: every
product's operands (and the gradient flowing into it) rounded to float8
e4m3 with a per-tensor scale, the step below the configuration's bfloat16.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from mdd_bench import manifest

BN_EPS = 1e-5
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
FP8_MAX = 448.0

# the recipe's canonical-phone substitutions (augment_mode 2): canonical
# phone -> plausible learner errors
COMMON_INCORRECT = {
    "t": ["r", "l", "n", "ah", "z", "uw", "dh", "s", "th", "f", "sh", "p", "ch", "ae", "d", "eh", "k", "sil", "er", "v"],
    "ah": ["l", "z", "uw", "uh", "ao", "ay", "ih", "ae", "aa", "d", "eh", "ow", "iy", "sil", "ey", "aw", "er", "t", "b"],
    "v": ["k", "r", "w", "sil", "l", "s", "p", "f", "er", "b"],
    "iy": ["jh", "sil", "er", "ah", "ey", "uw", "ay", "ih", "aw", "y", "eh", "ow"],
    "l": ["r", "w", "sil", "n", "iy", "ah", "z", "f", "ih", "er", "t", "eh"],
    "r": ["w", "sil", "l", "n", "uh", "iy", "ah", "ao", "z", "ey", "aa", "ih", "er", "d"],
    "sil": ["r", "l", "n", "ah", "z", "uw", "dh", "w", "s", "uh", "ao", "f", "sh", "ih", "m", "y", "jh", "p", "ae", "aa", "ng", "d", "eh", "k", "iy", "hh", "g", "er", "v", "t", "b"],
    "dh": ["r", "hh", "sil", "l", "s", "n", "th", "p", "z", "y", "er", "d", "t", "eh"],
    "ae": ["sil", "ao", "ah", "ey", "ay", "aa", "ih", "aw", "t", "eh"],
    "ow": ["iy", "r", "sil", "w", "uh", "ao", "ah", "uw", "aa", "ih", "oy", "aw", "er"],
    "p": ["k", "sil", "f", "er", "v", "t", "b"],
    "er": ["iy", "r", "sil", "l", "w", "uh", "ao", "ah", "uw", "aa", "eh", "ow"],
    "d": ["r", "l", "n", "ah", "z", "dh", "s", "zh", "th", "f", "jh", "p", "ng", "eh", "k", "iy", "sil", "g", "er", "v", "t", "b"],
    "ch": ["jh", "sil", "zh", "s", "dh", "sh", "t"],
    "ih": ["iy", "r", "sil", "n", "uh", "ah", "ey", "ae", "ay", "aa", "uw", "er", "eh"],
    "s": ["k", "hh", "sil", "zh", "th", "z", "sh", "t"],
    "z": ["r", "jh", "sil", "s", "zh", "g", "th", "f", "dh", "sh", "er", "t"],
    "aa": ["sil", "ao", "ah", "ae", "uw", "aw", "er", "eh", "ow"],
    "g": ["k", "jh", "hh", "sil", "er", "d", "b"],
    "ng": ["sil", "n", "l", "uh", "m"],
    "n": ["hh", "sil", "l", "p", "z", "f", "ng", "m", "y", "v", "d"],
    "hh": ["k", "jh", "sil", "g", "er", "ch", "sh", "y", "t"],
    "jh": ["k", "sil", "zh", "s", "g", "ch", "sh", "y", "er", "d", "t"],
    "uh": ["ao", "ah", "uw", "ih", "er", "ow"],
    "eh": ["iy", "r", "sil", "ah", "ey", "ae", "ay", "aa", "uw", "ih", "er", "ow"],
    "uw": ["iy", "w", "sil", "l", "uh", "ah", "ao", "aa", "ih", "oy", "ow"],
    "ey": ["iy", "sil", "ah", "ae", "ay", "aa", "ih", "eh"],
    "b": ["r", "sil", "ah", "p", "f", "v", "t"],
    "k": ["hh", "w", "sil", "s", "g", "ch", "dh", "er", "t"],
    "aw": ["uh", "ao", "ah", "ay", "aa", "ow"],
    "ay": ["iy", "r", "sil", "ah", "ey", "ae", "aa", "ih", "oy", "eh"],
    "sh": ["sil", "zh", "s", "ch", "t"],
    "zh": ["jh", "s", "z", "ch", "sh"],
    "y": ["jh", "iy", "sil", "ih", "er"],
    "f": ["sil", "p", "er", "v", "b"],
    "th": ["sil", "s", "p", "z", "ch", "f", "er", "d", "t"],
    "ao": ["sil", "l", "uh", "ah", "uw", "ae", "aa", "aw", "er", "eh", "ow"],
    "m": ["ng", "sil", "n"],
    "w": ["hh", "sil", "l", "g", "r", "ao", "y", "v"],
    "oy": ["ao", "ow", "ay"],
}


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# ---------------------------------------------------------------- classes

def n_classes(cfg: dict) -> int:
    return len(cfg["units"]) + 2          # blank, UNK, the units


# ---------------------------------------------------------------- batches

@dataclasses.dataclass
class RefBatch:
    bucket: int
    items: np.ndarray         # (B,) corpus item of each slot
    lengths: np.ndarray       # (B,) raw frames
    aug: np.ndarray           # (B, 4) [f, f0, w, t0]
    targets: np.ndarray       # (B, L)
    target_sizes: np.ndarray
    trans: np.ndarray         # (B, L2), mutated where valid
    trans_sizes: np.ndarray
    valid: np.ndarray         # (B,) bool


class Vocab:
    def __init__(self, units: Sequence[str]):
        self.ids = {"blank": 0, "UNK": 1}
        for u in units:
            self.ids.setdefault(u, len(self.ids))
        self.words = {i: w for w, i in self.ids.items()}

    def encode(self, phones: Sequence[str]) -> List[int]:
        return [self.ids.get(p, 1) for p in phones]


def spec_augment_params(t: int, v: int, rng) -> List[int]:
    """One frequency mask of width < 2 and one time mask of width < 5,
    the draws in the recipe's order: [f, f0, w, t0]."""
    f = int(rng.uniform(0.0, 2))
    f0 = int(rng.integers(0, v - f + 1))
    w = int(rng.uniform(0.0, 5))
    t0 = int(rng.integers(0, t - w + 1))
    return [f, f0, w, t0]


def mutate(ids: Sequence[int], vocab: Vocab, rng, prob: float) -> List[int]:
    """augment_mode 2: each phone replaced, with probability `prob`, by one
    of its common learner errors."""
    out = []
    for pid in ids:
        new = pid
        if rng.random() < prob:
            phone = vocab.words.get(pid)
            if phone in COMMON_INCORRECT:
                cands = [p for p in COMMON_INCORRECT[phone]
                         if p in vocab.ids]
                if cands:
                    new = vocab.ids[cands[rng.integers(len(cands))]]
        out.append(int(new))
    return out


def raw_quantum(cfg: dict) -> int:
    skip = max(cfg["n_skip_frame"], 1)
    return round_up(cfg["time_quantum"] * skip, skip * cfg["n_downsample"])


def schedule(lengths: np.ndarray, cfg: dict, batch: int, seed: int,
             epoch: int):
    """Epoch `epoch`'s (bucket, items) batches, in order: each bucket's
    items permuted, cut into batches, then the batches shuffled, all from
    default_rng(seed + epoch)."""
    q = raw_quantum(cfg)
    buckets: Dict[int, List[int]] = {}
    for i, t in enumerate(lengths):
        buckets.setdefault(round_up(int(t), q), []).append(i)
    rng = np.random.default_rng(seed + epoch)
    out = []
    for b in sorted(buckets):
        rows = buckets[b]
        chunk: List[int] = []
        for j in rng.permutation(len(rows)):
            chunk.append(rows[j])
            if len(chunk) == batch:
                out.append((b, chunk))
                chunk = []
        if chunk:
            out.append((b, chunk))
    rng.shuffle(out)
    return out


def make_batch(corpus, cfg: dict, vocab: Vocab, bucket: int,
               chunk: Sequence[int], batch: int, seed: int,
               epoch: int) -> RefBatch:
    n_real = len(chunk)
    items = np.asarray([chunk[min(k, n_real - 1)] for k in range(batch)])
    valid = np.arange(batch) < n_real
    lengths = np.asarray([corpus.feats[i].shape[0] for i in items])
    aug = np.zeros((batch, 4), np.int64)
    labels, trans = [], []
    for k, i in enumerate(items):
        tr = vocab.encode(corpus.canonical[i])
        if valid[k]:
            rng = np.random.default_rng((seed + epoch, int(i)))
            aug[k] = spec_augment_params(int(lengths[k]),
                                         cfg["feature_dim"], rng)
            tr = mutate(tr, vocab, rng, cfg["mutation_prob"])
        labels.append(vocab.encode(corpus.actual[i]))
        trans.append(tr)
    q = cfg["label_quantum"]

    def pad(seqs):
        out = np.zeros((batch, round_up(max(map(len, seqs)), q)), np.int64)
        for k, s in enumerate(seqs):
            out[k, :len(s)] = s
        return out, np.asarray([len(s) for s in seqs])

    targets, tsizes = pad(labels)
    tr_a, trsizes = pad(trans)
    return RefBatch(bucket, items, lengths, aug, targets, tsizes, tr_a,
                    trsizes, valid)


def first_batches(corpus, cfg: dict, mix: dict, seed: int, n: int,
                  rows: Optional[slice] = None) -> List[RefBatch]:
    """The first `n` batches of the run (epoch 0), all of each global
    batch's rows, or the slice `rows` of them."""
    vocab = Vocab(cfg["units"])
    sched = schedule(corpus.lengths, cfg, mix["batch_size"], seed, 0)
    out = []
    for bucket, chunk in sched[:n]:
        b = make_batch(corpus, cfg, vocab, bucket, chunk, mix["batch_size"],
                       seed, 0)
        if rows is not None:
            b = RefBatch(b.bucket, *(getattr(b, f.name)[rows] for f in
                                     dataclasses.fields(RefBatch)[1:]))
        out.append(b)
    return out


def raw_inputs(corpus, batch: RefBatch, device) -> torch.Tensor:
    """(B, T_bucket, 81) features on the bfloat16 wire, zero-padded, with
    each valid row's SpecAugment masks applied."""
    x = torch.zeros((len(batch.items), batch.bucket, corpus.feats[0].shape[1]),
                    dtype=torch.bfloat16)
    for k, i in enumerate(batch.items):
        x[k, :batch.lengths[k]] = torch.from_numpy(corpus.feats[i])
    for k, (f, f0, w, t0) in enumerate(batch.aug):
        x[k, :, f0:f0 + f] = 0
        x[k, t0:t0 + w, :] = 0
    return x.to(device)


def splice(raw: torch.Tensor, lengths: torch.Tensor, cfg: dict):
    """Context splice (edge frames repeated), frame skip and zeros past
    each row's length -> (spliced, model frames of each row)."""
    b, t_raw, d = raw.shape
    skip, left, right = cfg["n_skip_frame"], cfg["left_ctx"], cfg["right_ctx"]
    base = torch.arange(t_raw // skip, device=raw.device) * skip
    last = lengths[:, None] - 1
    cols = [torch.clamp(base - k, min=0).expand(b, -1)
            for k in range(left, 0, -1)]
    cols.append(base.expand(b, -1))
    cols += [torch.minimum(base[None] + k, last) for k in range(1, right + 1)]
    idx = torch.stack(cols, dim=2).clamp(0, t_raw - 1)
    rows = torch.arange(b, device=raw.device)[:, None, None]
    x = raw[rows, idx].reshape(b, base.shape[0], -1)
    x = x * (base[None] < lengths[:, None])[..., None].to(x.dtype)
    n = (lengths + skip - 1) // skip
    mult = cfg["n_downsample"]
    return x, (n + mult - 1) // mult * mult


# ---------------------------------------------------------------- model

def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = FP8_MAX / x.detach().abs().amax().clamp_min(1e-30)
    return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale


class _Fp8Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


def quantizer(precision: str):
    if precision == "float32":
        return lambda x: x
    if precision == "fp8":
        return _Fp8Round.apply
    raise ValueError(f"unknown reference precision {precision!r}")


def batch_norm(x, scale, bias, axis: int, valid):
    """Normalise with the mean and biased variance of the valid rows over
    every axis but `axis`; every row is normalised."""
    xs = x[valid]
    dims = [k for k in range(x.dim()) if k != axis % x.dim()]
    mean = xs.mean(dims, keepdim=True)
    var = ((xs - mean) ** 2).mean(dims, keepdim=True)
    shape = [1] * x.dim()
    shape[axis] = -1
    return (x - mean) * torch.rsqrt(var + BN_EPS) * scale.view(shape) \
        + bias.view(shape)


def dropout(x, rate: float, gens: List[torch.Generator]):
    """Each rank's rows (equal runs of the batch) masked from its own
    generator."""
    keep = torch.cat([
        torch.rand(part.shape, generator=g, device=x.device) < 1.0 - rate
        for part, g in zip(x.chunk(len(gens)), gens)])
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


@contextlib.contextmanager
def strict_float32():
    """TF32 off for the block (a float32 product may otherwise run at
    TF32's 10-bit mantissa on the card)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def dropout_generator(seed: int, device, rank: int = 0) -> torch.Generator:
    """The recipe's dropout stream: seeded (seed + 1 + rank * 0x9E3779B1)
    mod 2**32 on the run's device."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed + 1 + rank * 0x9E3779B1) % 2 ** 32)
    return gen


def run_steps(corpus, cfg: dict, batches: List[RefBatch],
              weights: Dict[str, torch.Tensor], seed: int, device,
              precision: str = "float32", world: int = 1,
              lr: Optional[float] = None,
              weight_decay: Optional[float] = None) -> dict:
    """The first len(batches) training steps from `weights`, each over the
    whole global batch (`world` ranks' equal row runs, each with its own
    dropout stream); -> per step the raw inputs, the log-probs, the loss
    and the input sizes, the first step's gradient as Adam takes it (with
    the decay term) and every parameter's change after the last step."""
    lr = cfg["init_lr"] if lr is None else lr
    wd = cfg["weight_decay"] if weight_decay is None else weight_decay
    q = quantizer(precision)
    family = manifest.family(cfg)
    P = {k: v.detach().to(device, torch.float32).clone().requires_grad_()
         for k, v in weights.items()}
    p0 = {k: v.detach().clone() for k, v in P.items()}
    m = {k: torch.zeros_like(v) for k, v in P.items()}
    v2 = {k: torch.zeros_like(v) for k, v in P.items()}
    gens = [dropout_generator(seed, device, r) for r in range(world)]
    out = {"inputs": [], "log_probs": [], "loss": [], "input_sizes": []}
    with strict_float32():
        for step, batch in enumerate(batches, start=1):
            raw = raw_inputs(corpus, batch, device)
            lengths = torch.as_tensor(batch.lengths, device=device)
            x, frames = splice(raw.float(), lengths, cfg)
            valid = torch.as_tensor(batch.valid, device=device)
            trans = torch.as_tensor(batch.trans, device=device)
            trsizes = torch.as_tensor(batch.trans_sizes, device=device)
            lp = family.forward(P, cfg, x, trans, trsizes, valid, gens, q)
            sizes = family.ctc_sizes(cfg, frames, x.shape[1], lp.shape[0])
            tg = torch.as_tensor(batch.targets, device=device)
            ts = torch.as_tensor(batch.target_sizes, device=device)
            nll = F.ctc_loss(lp.double(), tg, sizes, ts, blank=0,
                             reduction="none", zero_infinity=False)
            loss = (nll * valid).sum() / valid.sum()
            for p in P.values():
                p.grad = None
            loss.backward()
            with torch.no_grad():
                b1, b2 = ADAM_BETAS
                for k, p in P.items():
                    g = p.grad + wd * p
                    if step == 1:
                        out.setdefault("grad1", {})[k] = g.cpu()
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (v2[k].sqrt() / (1 - b2 ** step) ** 0.5
                             ).add_(ADAM_EPS)
                    p.addcdiv_(m[k], denom, value=-lr / (1 - b1 ** step))
            out["inputs"].append(raw.cpu())
            out["log_probs"].append(lp.detach().cpu())
            out["loss"].append(loss.item())
            out["input_sizes"].append(sizes.cpu())
    out["delta"] = {k: (P[k].detach() - p0[k]).cpu() for k in P}
    return out


# ---------------------------------------------------------------- judging

def greedy_wer(log_probs: torch.Tensor, sizes, targets, target_sizes,
               valid) -> tuple:
    """(errors, tokens) of the greedy decode of (T', B, C) log-probs: per
    valid row, the frames' argmax collapsed (repeats merged, blanks
    dropped) and its edit distance to the target."""
    ids = log_probs.argmax(-1).transpose(0, 1).numpy()
    errs = tokens = 0
    for k in range(ids.shape[0]):
        if not valid[k]:
            continue
        row = ids[k, :int(sizes[k])]
        keep = (row != 0) & (row != np.concatenate([[-1], row[:-1]]))
        hyp = row[keep]
        ref = np.asarray(targets[k][:int(target_sizes[k])])
        jr = np.arange(len(ref) + 1)
        d = jr
        for tok in hyp:
            # the insertion chain d[j] = min(c[j], d[j - 1] + 1) is a
            # running minimum of c[j] - j
            c = np.concatenate([d[:1] + 1, np.minimum(
                d[1:] + 1, d[:-1] + (ref != tok))])
            d = np.minimum.accumulate(c - jr) + jr
        errs += int(d[-1])
        tokens += len(ref)
    return errs, tokens
