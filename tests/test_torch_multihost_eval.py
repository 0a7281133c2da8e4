"""Multi-process evaluation's pieces against mdd_tpu's: the per-rank
shares (`shard_for_host`, `shard_for_host_primary`), `all_reduce_report`
as the one-process identity and over 2 real ranks (gloo), and scoring
each utterance once when the shares wrap around
(tests/test_multihost_eval.py holds mdd_tpu to the same, on the
reference's result dumps when they are mounted; here on seeded
triples)."""

import dataclasses
import json
import textwrap

import numpy as np
import pytest

import jax
from jax.experimental import multihost_utils

from mdd_tpu.data.prefetch import shard_for_host as jax_shard
from mdd_tpu.data.prefetch import shard_for_host_primary as jax_primary
from mdd_tpu.evals.evaluate import all_reduce_report as jax_all_reduce
from mdd_tpu.evals.evaluate import report_to_vector as jax_vector
from mdd_tpu.evals.evaluate import score_mdd as jax_score
from mdd_tpu_torch.data.prefetch import (shard_for_host,
                                         shard_for_host_primary)
from mdd_tpu_torch.evals.evaluate import (all_reduce_report,
                                          report_from_vector,
                                          report_to_vector, score_mdd)
from test_torch_distributed import spawn_ranks

PHONES = ["aa", "ae", "b", "d", "iy", "k", "s", "t", "sil"]


def make_triples(n: int = 101, seed: int = 0):
    """(utt, decoded, label, canonical): canonical phones, a label with
    about 20% substituted, a decode with substitutions, deletions and
    insertions against the label; every third speaker TXHC."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        canon = ["sil"] + list(rng.choice(PHONES[:-1],
                                          rng.integers(3, 12))) + ["sil"]
        label = [p if rng.random() > 0.2 else str(rng.choice(PHONES[:-1]))
                 for p in canon]
        dec = []
        for p in label:
            u = rng.random()
            if u < 0.1:
                continue
            dec.append(p if u > 0.25 else str(rng.choice(PHONES[:-1])))
            if rng.random() < 0.05:
                dec.append(str(rng.choice(PHONES[:-1])))
        spk = "TXHC" if i % 3 == 0 else "ABA"
        out.append((f"{spk}_{i:04d}", dec, label, canon))
    return out


@pytest.fixture(scope="module")
def triples():
    return make_triples()


@pytest.mark.parametrize("n,procs", [(0, 1), (7, 1), (7, 2), (7, 3),
                                     (12, 4), (101, 8), (5, 8)])
def test_shares_equal_mdd_tpu(n, procs):
    items = [f"u{i}" for i in range(n)]
    for p in range(procs):
        assert shard_for_host(items, p, procs) == jax_shard(items, p, procs)
        assert (shard_for_host_primary(items, p, procs)
                == jax_primary(items, p, procs))


def test_report_vectors_equal_mdd_tpu(triples):
    assert (report_to_vector(score_mdd(triples)).tolist()
            == jax_vector(jax_score(triples)).tolist())


def test_all_reduce_report_is_the_identity_in_one_process(triples):
    rep = score_mdd(triples[:50])
    rep.decode_minutes = 1.5
    out = all_reduce_report(rep)
    assert dataclasses.asdict(out) == dataclasses.asdict(rep)
    want = jax_all_reduce(jax_score(triples[:50]))
    assert report_to_vector(out).tolist() == jax_vector(want).tolist()


@pytest.mark.parametrize("procs", [2, 4, 8])
def test_wraparound_duplicates_are_not_double_counted(triples, procs):
    """101 utterances over P ranks: summing every rank's report over its
    scoring-primary rows equals the one-process report; all rows would
    count a duplicate twice."""
    full = report_to_vector(score_mdd(triples))
    total = np.zeros_like(full)
    rows = 0
    for p in range(procs):
        share, primary = shard_for_host_primary(triples, p, procs)
        rows += len(share)
        total += report_to_vector(score_mdd(
            [t for t, keep in zip(share, primary) if keep]))
    assert rows > len(triples)           # the wrap-around is real
    assert total.tolist() == full.tolist()


WORKER = textwrap.dedent('''\
    import json, sys
    from mdd_tpu_torch.parallel import mesh
    from mdd_tpu_torch.data.prefetch import shard_for_host_primary
    from mdd_tpu_torch.evals.evaluate import (all_reduce_report,
                                              report_to_vector, score_mdd)
    with mesh.joined("cpu"):
        triples = json.load(open(sys.argv[1]))
        r, n = mesh.process_index(), mesh.process_count()
        share, primary = shard_for_host_primary(triples, r, n)
        rep = score_mdd([t for t, k in zip(share, primary) if k])
        rep.decode_minutes = 0.25 * (r + 1)
        out = all_reduce_report(rep)
        json.dump({"vector": report_to_vector(out).tolist(),
                   "minutes": out.decode_minutes},
                  open(sys.argv[2].replace("RANK", str(r)), "w"))
''')


def test_all_reduce_report_over_two_ranks(triples, tmp_path, monkeypatch):
    """Each rank scores its share of 101 utterances and sums the tallies:
    every rank gets the one-process report, as mdd_tpu's all_reduce_report
    gives on its process_allgather (simulated there as in its own test);
    decode_minutes stays the rank's."""
    (tmp_path / "t.json").write_text(json.dumps(triples))
    (tmp_path / "w.py").write_text(WORKER)
    spawn_ranks([str(tmp_path / "w.py"), str(tmp_path / "t.json"),
                 str(tmp_path / "rRANK.json")], 2)
    got = [json.loads((tmp_path / f"r{r}.json").read_text())
           for r in (0, 1)]

    shares = [jax_primary(triples, r, 2) for r in (0, 1)]
    reps = [jax_score([t for t, k in zip(*s) if k]) for s in shares]
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(multihost_utils, "process_allgather",
                        lambda tree: np.stack([np.asarray(tree),
                                               jax_vector(reps[1])]))
    want = jax_vector(jax_all_reduce(reps[0])).tolist()
    full = report_to_vector(score_mdd(triples)).tolist()
    assert got[0]["vector"] == got[1]["vector"] == want == full
    assert [g["minutes"] for g in got] == [0.25, 0.5]
    assert report_from_vector(np.asarray(want)).n_utts == len(triples)
