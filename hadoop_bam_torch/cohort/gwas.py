"""GWAS columns over the joined [variants, samples] tensor (counterpart of
hadoop_bam_tpu/cohort/gwas.py).

One step a tile computes, per variant row:

- **allele frequency** ``af = alt_allele_sum / (2 * n_called)``: diploid
  ALT frequency over called samples (NaN when nothing is called);
- **call rate** ``n_called / n_samples``;
- **HWE chi-square**: observed diploid genotype counts (hom-ref / het /
  hom-alt among called samples with dosage <= 2) against Hardy-Weinberg
  expectation at the observed allele frequency, 1 d.f. (NaN when no
  classed genotypes);
- **score-test association** against a phenotype vector ``y`` (the
  1-d.f. score test of H0: beta_g = 0 in ``y = mu + beta_g * g``)::

      U  = sum_i (y_i - ybar)(g_i - gbar)      over called, phenotyped i
      Vg = sum_i (g_i - gbar)^2
      Vy = sum_i (y_i - ybar)^2 / n            (MLE variance under H0)
      chi2 = U^2 / (Vy * Vg)                   (NaN when Vy*Vg ~ 0)

The step is K17a (``cohort_gwas_step``): a hand CUDA kernel
(``csrc/cohort_stats.cu``) on a CUDA tensor, its plain PyTorch version
``cohort_gwas_plain`` (the reference's formulas line for line) on a CPU
tensor.  The reference jits the same formulas as XLA code under
``shard_map``; the rows are reductions along the sample axis, so a tile
needs no collective.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from hadoop_bam_torch.config import DEFAULT_CONFIG, HBamConfig
from hadoop_bam_torch.ops import kernels
from hadoop_bam_torch.utils.errors import PlanError
from hadoop_bam_torch.utils.metrics import METRICS

# columns of the per-variant stats tensor the step returns, in order
GWAS_COLUMNS = ("af", "call_rate", "hwe_chi2", "score_chi2")


def _count_tensor(count, device: torch.device) -> torch.Tensor:
    """``count`` (an int, or an int [1] tensor) as an int32 [1] tensor on
    ``device``; a tensor already there is used as it is (no host read)."""
    if isinstance(count, torch.Tensor):
        if count.dtype == torch.int32 and count.shape == (1,) \
                and count.device == device:
            return count
        c = count.reshape(-1)[:1]
        if c.dtype != torch.int32:
            c = c.to(torch.int32)
        return c.to(device)
    return torch.tensor([int(count)], dtype=torch.int32, device=device)


def cohort_gwas_plain(dosage: torch.Tensor, count, pheno: Optional[
        torch.Tensor], n_samples: int) -> torch.Tensor:
    """K17a's plain version: the reference's ``per_device`` (cohort/
    gwas.py:61-120) in torch ops, float32 in its order.  ``dosage`` int8
    [1, cap, samples_pad], ``count`` the live rows (int or int [1]),
    ``pheno`` float32 [samples_pad] or None, ``n_samples`` the columns
    that count.  Returns float32 [1, cap, 4] (``GWAS_COLUMNS``)."""
    dev = dosage.device
    d = dosage[0].to(torch.int32)
    count = _count_tensor(count, dev)[0]
    cap, spad = d.shape
    S = int(n_samples)
    nan = torch.tensor(float("nan"), dtype=torch.float32, device=dev)
    valid = torch.arange(cap, dtype=torch.int32, device=dev) < count
    samp = torch.arange(spad, dtype=torch.int32, device=dev) < S
    called = (d >= 0) & samp[None, :]
    n_called = called.sum(dim=1, dtype=torch.int32)
    ncf = n_called.to(torch.float32)
    alt = torch.where(called, d, 0).sum(dim=1, dtype=torch.int32) \
        .to(torch.float32)
    has = n_called > 0
    af = torch.where(has, alt / (2.0 * torch.clamp(ncf, min=1.0)), nan)
    # the reference's compiled step divides by the constant sample
    # count as a multiply by its float32 reciprocal (XLA's rewrite of a
    # division by a constant): the same rounding here
    recip = np.float32(1.0) / np.float32(max(S, 1))
    call_rate = ncf * torch.tensor(recip, dtype=torch.float32, device=dev)

    # HWE: diploid-classed genotypes only (dosage 0/1/2); a dosage above
    # 2 counts as called but is left out of the table
    n0 = ((d == 0) & called).sum(dim=1, dtype=torch.int32).to(torch.float32)
    n1 = ((d == 1) & called).sum(dim=1, dtype=torch.int32).to(torch.float32)
    n2 = ((d == 2) & called).sum(dim=1, dtype=torch.int32).to(torch.float32)
    m = n0 + n1 + n2
    msafe = torch.clamp(m, min=1.0)
    p = (2.0 * n2 + n1) / (2.0 * msafe)
    e0 = (1.0 - p) ** 2 * m
    e1 = 2.0 * p * (1.0 - p) * m
    e2 = p ** 2 * m

    def term(obs, exp):
        return torch.where(exp > 0, (obs - exp) ** 2
                           / torch.clamp(exp, min=1e-12), 0.0)

    hwe = torch.where(m > 0, term(n0, e0) + term(n1, e1) + term(n2, e2),
                      nan)

    if pheno is not None:
        pheno = pheno.to(device=dev, dtype=torch.float32)
        yok = torch.isfinite(pheno) & samp
        use = called & yok[None, :]
        uf = use.to(torch.float32)
        n = uf.sum(dim=1)
        nsafe = torch.clamp(n, min=1.0)
        y = torch.where(yok, pheno, 0.0)[None, :]
        g = torch.where(use, d, 0).to(torch.float32)
        sy = (y * uf).sum(dim=1)
        sg = g.sum(dim=1)
        sgy = (g * y).sum(dim=1)
        sgg = (g * g).sum(dim=1)
        syy = (y * y * uf).sum(dim=1)
        u_stat = sgy - sy * sg / nsafe
        vg = sgg - sg * sg / nsafe
        vy = (syy - sy * sy / nsafe) / nsafe
        denom = vy * vg
        score = torch.where((n > 1) & (denom > 1e-12),
                            u_stat * u_stat / torch.clamp(denom, min=1e-12),
                            nan)
    else:
        score = torch.full((cap,), float("nan"), dtype=torch.float32,
                           device=dev)

    stats = torch.stack([af, call_rate, hwe, score], dim=1)
    # padding rows report NaN across the board, never a fake 0 stat
    return torch.where(valid[:, None], stats, nan)[None]


def _check_step_args(dosage: torch.Tensor, pheno) -> None:
    if dosage.dtype != torch.int8 or dosage.dim() != 3 \
            or dosage.shape[0] != 1:
        raise ValueError(f"dosage must be int8 [1, cap, samples_pad], got "
                         f"{dosage.dtype} {tuple(dosage.shape)}")
    spad = dosage.shape[2]
    if spad % 8:
        raise ValueError(f"samples_pad {spad} is not a multiple of 8")
    if pheno is not None:
        if pheno.dtype != torch.float32 or pheno.shape != (spad,):
            raise ValueError(f"pheno must be float32 [{spad}], got "
                             f"{pheno.dtype} {tuple(pheno.shape)}")
        if pheno.device != dosage.device:
            raise ValueError(f"dosage on {dosage.device}, pheno on "
                             f"{pheno.device}")


def cohort_gwas_step(dosage: torch.Tensor, count, pheno: Optional[
        torch.Tensor], n_samples: int) -> torch.Tensor:
    """K17a: the four ``GWAS_COLUMNS`` of each row of a joined dosage tile
    (int8 [1, cap, samples_pad], samples_pad a multiple of 8) for rows
    under ``count`` (an int or an int [1] tensor; rows past it are NaN),
    over the first ``n_samples`` columns, with the score test against
    ``pheno`` (float32 [samples_pad], NaN: that sample drops out of the
    score test) or NaN without one.  Returns float32 [1, cap, 4].

    A CUDA tensor launches the kernel (``csrc/cohort_stats.cu``) on the
    current stream, which reads the count from device memory (no host
    read); a CPU tensor takes ``cohort_gwas_plain``.  A kernel that
    fails to build or launch raises.  ``cohort_gwas_step.launches``
    counts kernel launches."""
    _check_step_args(dosage, pheno)
    if dosage.device.type == "cpu":
        return cohort_gwas_plain(dosage, count, pheno, n_samples)
    if dosage.device.type != "cuda":
        raise ValueError(f"unsupported device {dosage.device}")
    _, cap, spad = dosage.shape
    d = dosage.contiguous()
    c = _count_tensor(count, d.device)
    y = None if pheno is None else pheno.contiguous()
    if d.data_ptr() % 8 or (y is not None and y.data_ptr() % 16):
        raise ValueError("dosage must start 8-byte aligned and pheno "
                         "16-byte aligned")
    out = torch.empty((1, cap, len(GWAS_COLUMNS)), dtype=torch.float32,
                      device=d.device)
    if cap:
        fn = kernels.kernel("cohort_stats")
        with torch.cuda.device(d.device):
            rc = fn(d.data_ptr(), cap, spad, c.data_ptr(),
                    None if y is None else y.data_ptr(), int(n_samples),
                    out.data_ptr(),
                    torch.cuda.current_stream(d.device).cuda_stream)
        kernels.check_launch("cohort_gwas_step", rc)
        cohort_gwas_step.launches += 1
    return out


cohort_gwas_step.launches = 0


def cohort_gwas(source, phenotype=None, device=None,
                config: HBamConfig = DEFAULT_CONFIG,
                geometry=None) -> Dict[str, np.ndarray]:
    """Drive the joined cohort through K17a: returns per-variant arrays
    ``chrom`` / ``pos`` / ``n_allele`` plus the ``GWAS_COLUMNS`` float32
    stats (and ``n_variants``, ``sample_ids``, ``quarantined``).

    ``source`` is a ``CohortDataset`` (its device) or anything
    ``open_cohort`` takes (then on ``device``).  ``phenotype`` is one
    float per manifest sample (NaN = missing; that sample drops out of
    the score test only); a vector of another length is a PlanError.
    Each tile's step is spanned as ``cohort.kernel_wall``."""
    from hadoop_bam_torch.cohort.dataset import CohortDataset

    ds = source if isinstance(source, CohortDataset) \
        else CohortDataset(source, device=device, config=config)
    if geometry is None:
        geometry = ds.geometry
    pheno_dev = None
    if phenotype is not None:
        y = np.asarray(phenotype, dtype=np.float32)
        if y.shape != (ds.n_samples,):
            raise PlanError(
                f"phenotype must be one value per manifest sample "
                f"({ds.n_samples}), got shape {tuple(y.shape)}")
        ypad = np.full(ds.geometry.samples_pad, np.nan, np.float32)
        ypad[:ds.n_samples] = y
        pheno_dev = torch.from_numpy(ypad).to(ds.device)

    chroms, poss, nalls, stats_parts = [], [], [], []
    for out in ds.tensor_batches(geometry):
        with METRICS.span("cohort.kernel_wall"):
            stats = cohort_gwas_step(out["dosage"], out["n_records"],
                                     pheno_dev, ds.n_samples)
        c = int(out["n_records"][0])
        if c:
            chroms.append(out["chrom"][0, :c].cpu().numpy())
            poss.append(out["pos"][0, :c].cpu().numpy())
            nalls.append(out["n_allele"][0, :c].cpu().numpy())
            stats_parts.append(stats[0, :c].cpu().numpy())
    if stats_parts:
        stats_all = np.concatenate(stats_parts, axis=0)
        chrom = np.concatenate(chroms)
        pos = np.concatenate(poss)
        nall = np.concatenate(nalls)
    else:
        stats_all = np.empty((0, len(GWAS_COLUMNS)), np.float32)
        chrom = np.empty(0, np.int32)
        pos = np.empty(0, np.int32)
        nall = np.empty(0, np.int16)
    res = {
        "n_variants": int(stats_all.shape[0]),
        "chrom": chrom, "pos": pos, "n_allele": nall,
        "sample_ids": list(ds.sample_ids),
        "quarantined": dict(ds.manifest.quarantined),
    }
    for j, name in enumerate(GWAS_COLUMNS):
        res[name] = stats_all[:, j]
    return res
