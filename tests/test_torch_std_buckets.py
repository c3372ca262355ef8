"""Std launches at every node bucket a launch may take (256-3,072 nodes)
and at the smallest and largest sequence bucket (1,024 and 49,152 bp),
on the card: every kernel call of the launch against its plain twin on
the same operands, as `chip_smoke.py` holds it (star, the seg-scan and
the std DP equal, phase-cumsum within its round-once bound).  The
contigs are call 0 of the benchmark's short-read assembly mix."""

import concurrent.futures

import pytest

torch = pytest.importorskip("torch")

from pyrodigal_tpu_torch.metagenomic import METAGENOMIC_BINS  # noqa: E402
from pyrodigal_tpu_torch.ops import meta_cuda  # noqa: E402
from pyrodigal_tpu_torch.ops.meta_cuda import CudaMetaRunner  # noqa: E402
from pyrodigal_tpu_torch.sequence import Sequence  # noqa: E402

needs_bins = pytest.mark.skipif(
    len(METAGENOMIC_BINS) == 0,
    reason="metagenomic bins asset not built (scripts/build_bins.py)",
)

SEED = 2_718_281_829


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.mark.cuda
@needs_bins
def test_card_std_launch_at_every_bucket(cuda_device):
    import chip_smoke as cs
    from genebench import generate

    call = generate.make(SEED, generate.load_mix("short_contigs"))[0]
    card = CudaMetaRunner(METAGENOMIC_BINS, device=cuda_device)
    try:
        with concurrent.futures.ThreadPoolExecutor(8) as ex:
            preps = list(ex.map(
                lambda s: card._prepare_contig(Sequence(s[1])), call))
        items = [(ci, cand, geoms) for ci, (cand, geoms, _nbt, route)
                 in enumerate(preps) if route == "std" and cand]
        buckets = {}
        for label, work, geoms in cs.std_rung_launches(card, items):
            packed, *_ = card._std_inputs(work, geoms)
            buckets[label] = (packed["n32"].shape[2],
                              packed["digits"].shape[1])
            calls = cs._captured(card._sweep_std, work, geoms)
            assert cs._std_kernel_set({c[0] for c in calls}), label
            for name, a, got in calls:
                cs._check_call(f"{label}: {name}", name, a, got)
    finally:
        card.close()
    assert [buckets[f"nodes {r}"][0] for r in meta_cuda.NODE_RUNGS] \
        == list(meta_cuda.NODE_RUNGS)
    assert buckets[f"nodes {meta_cuda.NODE_BUCKET}"][0] \
        == meta_cuda.NODE_BUCKET
    assert buckets["shortest"][1] == meta_cuda.SEQ_STEP
    assert buckets["longest"][1] == meta_cuda.SEQ_BUCKET
