"""BGZF split guesser (copy of hadoop_bam_tpu/split/bgzf_guesser.py): the
next confirmed BGZF block start at or after an arbitrary file offset.

A vectorized scan finds magic + BC-subfield candidates in a window; each
candidate is confirmed by inflating a couple of consecutive blocks.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from hadoop_bam_torch.formats import bgzf
from hadoop_bam_torch.utils.seekable import ByteSource, as_byte_source


class BGZFSplitGuesser:

    # one max-size block guarantees a start in-window; 2 for slack against
    # candidates that fail confirmation near the window edge
    WINDOW = 2 * bgzf.MAX_BLOCK_SIZE

    def __init__(self, source, confirm_blocks: int = 2):
        self._src: ByteSource = as_byte_source(source)
        self._confirm_blocks = confirm_blocks

    def guess_next_block_start(self, offset: int,
                               inflated: Optional[dict] = None
                               ) -> Optional[int]:
        """Smallest confirmed BGZF block start >= offset, or None.  When
        ``inflated`` is a dict, it receives {coffset: payload} of the
        blocks the confirmation of the returned start inflated."""
        end = self._src.size
        if offset >= end:
            return None
        window_off = offset
        for _ in range(2):
            win = self._src.pread(window_off, self.WINDOW + bgzf.HEADER_SIZE)
            arr = np.frombuffer(win, dtype=np.uint8)
            for cand in bgzf.find_block_starts_numpy(arr):
                abs_off = window_off + int(cand)
                if abs_off < offset:
                    continue
                if inflated is not None:
                    inflated.clear()
                if self._confirm(abs_off, inflated):
                    return abs_off
            if window_off + len(win) >= end:
                return None
            window_off += self.WINDOW
        return None

    def _confirm(self, coffset: int, inflated: Optional[dict] = None
                 ) -> bool:
        """Inflate up to confirm_blocks consecutive blocks starting here."""
        for _ in range(self._confirm_blocks):
            head = self._src.pread(coffset, bgzf.MAX_BLOCK_SIZE)
            if not head:
                return True  # chain ran off EOF cleanly
            try:
                info = bgzf.parse_block_header(head, 0)
                data = bgzf.inflate_block(head, info, check_crc=True)
            except bgzf.BGZFError:
                return False
            if inflated is not None:
                inflated[coffset] = data
            coffset += info.block_size
            if coffset == self._src.size:
                return True
            if coffset > self._src.size:
                return False
        return True
