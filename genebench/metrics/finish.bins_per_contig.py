"""Exact re-runs per contig in meta mode's finishing: bins re-scored on
the exact engine (`_score_winner` inside `_produce_winner`) over the
contigs finished; 1.0 is no wasted re-run."""


def read(run):
    n = run.counts.get("winner_contigs", 0)
    if not n:
        return None
    return run.counts["exact_reruns"] / n
