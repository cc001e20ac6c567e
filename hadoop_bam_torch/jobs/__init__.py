"""Job-level defences of the port: ``speculate``, the decaying unit
latency tracker behind the span window's speculative second copies;
``journal``, the durable job journal; ``runner``, the resume policy of
the mesh sort's, duplicate marking's and the cohort join's jobs."""
from hadoop_bam_torch.jobs.journal import (     # noqa: F401
    JOURNAL_SUFFIX, JobJournal, JournalState, config_fingerprint,
    file_digest, file_identity_digest, journal_path_for, plan_digest,
    sweep_unrecorded, verify_artifact,
)
from hadoop_bam_torch.jobs.runner import (      # noqa: F401
    COHORT_FINGERPRINT_FIELDS, SORT_FINGERPRINT_FIELDS, resume_job, run_job_level, sort_job_params,
)
