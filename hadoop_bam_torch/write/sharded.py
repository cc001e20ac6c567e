"""ShardedFileWriter: deterministic part files and atomic publication
(copy of hadoop_bam_tpu/write/sharded.py without ``write_shards_journaled``,
which no caller of the port needs).

A sharded producer writes part k into ``<final><suffix>/part-NNNNN``
and then concatenates the parts into the final file (the duplicate-
marking write at more than one device; at one it has a single bucket
and writes the output directly).  Two atomicity rules:

- each part is written to ``part-NNNNN.tmp`` and renamed into place when
  its block exits cleanly, so a crash never leaves a plausible-looking
  truncated part for the merge;
- the final file comes from a build callback that itself publishes
  through a temp file and ``os.replace`` (``write/api.py`` does), so a
  partial output is never visible under the final name.

Resume: the producer journals each committed part's size and CRC as a
``("shard", k)`` unit; ``shard_committed`` verifies a part against that
record, so a resumed run skips rewriting it, and ``sweep_stale_temps``
removes the ``*.tmp`` orphans of the write that was in flight when the
previous run died.
"""
from __future__ import annotations

import contextlib
import os
import shutil
from typing import Callable, Iterator, List, Sequence

from hadoop_bam_torch.utils.metrics import METRICS


class ShardedFileWriter:
    """Per-part temp files and ordered concatenation (module docstring).

    ``resume_state`` (the replayed ``JournalState`` of a prior attempt)
    lets ``shard_committed`` skip the parts that attempt finished."""

    def __init__(self, final_path: str, n_shards: int, *,
                 dir_suffix: str = ".hbam-shards",
                 resume_state=None):
        self.final_path = final_path
        self.n_shards = int(n_shards)
        self.shard_dir = final_path + dir_suffix
        self.resume_state = resume_state

    def prepare(self) -> None:
        """Remove the parts of an earlier failed run, sweeping (and
        counting) its orphaned temps first."""
        self.sweep_stale_temps()
        shutil.rmtree(self.shard_dir, ignore_errors=True)

    def sweep_stale_temps(self) -> int:
        """Unlink the ``*.tmp`` orphans a crashed run left in the part
        directory; returns the count (also the ``write.stale_temps_swept``
        counter).  A resume calls this instead of ``prepare``: committed
        parts survive, only the in-flight write's debris goes."""
        try:
            names = os.listdir(self.shard_dir)
        except OSError:
            return 0
        swept = 0
        for name in names:
            if not name.endswith(".tmp"):
                continue
            with contextlib.suppress(OSError):
                os.unlink(os.path.join(self.shard_dir, name))
                swept += 1
        if swept:
            METRICS.count("write.stale_temps_swept", swept)
        return swept

    def shard_path(self, k: int) -> str:
        return os.path.join(self.shard_dir, f"part-{k:05d}")

    def shard_committed(self, k: int) -> bool:
        """True when a prior attempt's journal committed part ``k`` and
        the file on disk still has the recorded size and CRC (verified,
        not trusted: a part the crash corrupted is rewritten)."""
        if self.resume_state is None:
            return False
        from hadoop_bam_torch.jobs.journal import verify_artifact
        unit = self.resume_state.unit("shard", k)
        if unit is None:
            return False
        ok = verify_artifact(self.shard_path(k), unit.get("size", -1),
                             unit.get("crc", ""))
        if ok:
            METRICS.count("jobs.shards_skipped")
        return ok

    @contextlib.contextmanager
    def open_shard(self, k: int) -> Iterator:
        """Open part ``k`` for writing; it appears under its name only
        when the block exits cleanly."""
        os.makedirs(self.shard_dir, exist_ok=True)
        part = self.shard_path(k)
        tmp_part = part + ".tmp"
        f = open(tmp_part, "wb")
        try:
            yield f
        except BaseException:
            f.close()
            with contextlib.suppress(OSError):
                os.unlink(tmp_part)
            raise
        f.close()
        os.replace(tmp_part, part)

    def parts(self) -> List[str]:
        return [self.shard_path(k) for k in range(self.n_shards)]

    def missing_parts(self) -> List[str]:
        return [p for p in self.parts() if not os.path.exists(p)]

    def concatenate(self, build: Callable[[Sequence[str]], object],
                    what: str = "sharded write",
                    cleanup: bool = True) -> object:
        """Run ``build(parts)``, which publishes the final file atomically
        itself, then remove the part directory (``cleanup=False`` keeps
        it).  Refuses on missing parts: every shard writes exactly one
        part, empty ones included, so a missing part is lag or loss."""
        missing = self.missing_parts()
        if missing:
            from hadoop_bam_torch.utils.errors import TransientIOError
            raise TransientIOError(
                f"{what}: shard(s) missing at merge time: {missing[:3]}"
                f"{'...' if len(missing) > 3 else ''}; is "
                f"{self.shard_dir} on a filesystem every writer shares?")
        result = build(self.parts())
        if cleanup:
            self.cleanup()
        return result

    def cleanup(self) -> None:
        shutil.rmtree(self.shard_dir, ignore_errors=True)
