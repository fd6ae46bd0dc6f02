"""The census of a k-rank gloo group (``sgcn_tpu_torch/analysis``): one
spawn of ``torch_rank_child.ANALYSIS_K`` ranks on the census fixture's
k-part plan, each rank's step held to the plan's expectation.

A group of k ranks is what the CPU report's one rank on a slice cannot
show: real ring rounds (one ``batch_isend_irecv`` per live round, no
loopback copies), every rank's own part, and the order of each
aggregation — the exchange issued, the local K1 pass launched, then the
wait (``overlap-order``).  Covered: GCN a2a and ring training, GAT a2a
training and a served GCN batch on the ring (exchange-census).
"""

import pytest

import torch_rank_child as child
from sgcn_tpu_torch.analysis import census
from sgcn_tpu_torch.ops.pspmm import ragged_live_rounds

K = child.ANALYSIS_K


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("analysis_ranks")
    return child.spawn_ranks(child.analysis_ranks_main, K, str(out))


def _live_rounds():
    plan = census.audit_plan("er", K)
    return len(ragged_live_rounds(plan.ragged_round_sizes()))


@pytest.mark.parametrize("rank", range(K))
def test_every_rank_census_clean(ranks, rank):
    res = ranks[rank]
    assert set(res) == {"train/gcn/a2a/s0/f32/ranks",
                        "train/gcn/ragged/s0/f32/ranks",
                        "train/gat/a2a/fused/ranks",
                        "serve/gcn/ragged/s0/f32/ranks"}
    for mode_id, case in res.items():
        assert case["violations"] == [], (rank, mode_id, case["violations"])


@pytest.mark.parametrize("rank", range(K))
def test_ring_rounds_are_real_sends(ranks, rank):
    """On k ranks every live ring round is one batch_isend_irecv (three
    exchanges a GCN step, two layers a served batch) and no round is a
    loopback copy."""
    live = _live_rounds()
    assert live == K - 1
    for mode_id, exchanges in (("train/gcn/ragged/s0/f32/ranks", 3),
                               ("serve/gcn/ragged/s0/f32/ranks", 2)):
        labels = [r[1] for r in ranks[rank][mode_id]["records"]]
        assert labels.count("isend_irecv") == exchanges * live
        assert "loopback" not in labels and "all_to_all" not in labels


@pytest.mark.parametrize("rank", range(K))
def test_overlap_order(ranks, rank):
    """A GCN aggregation issues its exchange, launches the local K1 pass
    and only then waits (then the halo pass); the GAT table's exchange is
    waited on before its K5 pass (nothing to overlap)."""
    for mode_id in ("train/gcn/a2a/s0/f32/ranks",
                    "train/gcn/ragged/s0/f32/ranks",
                    "serve/gcn/ragged/s0/f32/ranks"):
        case = ranks[rank][mode_id]
        assert case["overlapped"] == case["expected"]["overlapped"] > 0
    gat = ranks[rank]["train/gat/a2a/fused/ranks"]
    assert gat["overlapped"] == 0
    recs = gat["records"]
    for i, r in enumerate(recs):
        if r[1] == "all_to_all":
            assert recs[i + 1][1] == "wait"


def test_served_batch_is_one_round_on_every_rank(ranks):
    """A served batch: the header and id broadcasts, one all-gather of the
    masked rows, the same on rank 0 and the followers; the header's fields
    are the only host reads."""
    seqs = []
    for rank in range(K):
        case = ranks[rank]["serve/gcn/ragged/s0/f32/ranks"]
        labels = [r[1] for r in case["records"] if r[0] == "collective"
                  and r[1] in ("broadcast", "all_gather")]
        assert labels == ["broadcast", "broadcast", "all_gather"]
        assert case["host_reads"] == 5
        seqs.append([r[:2] for r in case["records"]])
    # the followers run the leader's batch: the same launches and
    # collectives in the same order
    assert all(s == seqs[0] for s in seqs[1:])
