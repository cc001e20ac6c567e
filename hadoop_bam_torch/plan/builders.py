"""Plan builders (trimmed copy of hadoop_bam_tpu/plan/builders.py): the
cohort join's plan, whose digest the journaled join records.  The other
builders wait for the plan-IR runner (``execute``, ``hbam explain``)."""
from __future__ import annotations

from typing import Optional

from hadoop_bam_torch.config import DEFAULT_CONFIG, HBamConfig
from hadoop_bam_torch.plan.ir import (
    PlanIR, SinkIR, SourceIR, SpansIR, op_node,
)


def cohort_plan(manifest, config: Optional[HBamConfig] = None,
                geometry=None) -> PlanIR:
    """Cohort tensor batches: k single-sample call sets k-way
    position-joined, allele-harmonized, packed into [variants, samples]
    dosage / qual tiles.

    The digest covers the manifest identity (anchor and each input's
    file identity) and the join's knobs, which is what the journaled
    join's refuse-to-resume contract needs.  The feed's tile height is
    left out: the journaled chunks are cut by ``chunk_sites`` and shaped
    by ``samples_pad``, and another tile height replays them as they
    are."""
    from hadoop_bam_torch.cohort.manifest import as_manifest

    cfg = config if config is not None else DEFAULT_CONFIG
    m = as_manifest(manifest)
    anchor, k, digest = m.identity()
    if geometry is None:
        from hadoop_bam_torch.parallel.variant_pipeline import (
            VariantGeometry,
        )
        geometry = VariantGeometry(n_samples=k)
    return PlanIR(
        source=SourceIR(anchor or "<inline-manifest>", "cohort",
                        role="join"),
        spans=SpansIR.auto(),
        ops=(op_node("kway_join", samples=k, manifest_digest=digest,
                     chunk_sites=cfg.cohort_chunk_sites),
             op_node("variant_pack",
                     samples_pad=geometry.samples_pad)),
        sink=SinkIR.of("tensor_batches"))
