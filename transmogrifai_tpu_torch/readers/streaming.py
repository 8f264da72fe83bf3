"""Streaming readers: micro-batch record streams for scoring.

The port's own copy of ``transmogrifai_tpu/readers/streaming.py``, from
the reference streaming stack
(readers/src/main/scala/com/salesforce/op/readers/StreamingReader.scala:54
and StreamingReaders.scala:43-59): the reference turns a directory of
Avro files into a Spark DStream of micro-batches; here a
:class:`StreamingReader` yields batches of dict records that plug
straight into ``WorkflowModel.score`` (``WorkflowRunner.streaming_score``
waits for the port of ``workflow/runner.py``).
Sources: an iterable of records (chunked), a directory of Avro/CSV
files (one batch per file — the DStream fileStream analogue), or any
iterator of pre-built batches.
"""
from __future__ import annotations

import glob
import os
from typing import Callable, Iterable, Iterator, List, Optional

__all__ = ["StreamingReader", "StreamingReaders"]


class StreamingReader:
    """A re-iterable stream of record micro-batches."""

    def __init__(self, batch_source: Callable[[], Iterator[List[dict]]]):
        self._batch_source = batch_source

    def stream(self) -> Iterator[List[dict]]:
        """(reference StreamingReader.stream:54)"""
        return self._batch_source()

    def __iter__(self) -> Iterator[List[dict]]:
        return self.stream()

    # -- constructors ------------------------------------------------------
    @staticmethod
    def from_records(records: Iterable[dict],
                     batch_size: int = 1000) -> "StreamingReader":
        """Chunk an iterable of records into fixed-size micro-batches."""
        records = list(records)

        def gen():
            for i in range(0, len(records), batch_size):
                yield records[i:i + batch_size]
        return StreamingReader(gen)

    @staticmethod
    def from_batches(batches: Iterable[List[dict]]) -> "StreamingReader":
        batches = [list(b) for b in batches]
        return StreamingReader(lambda: iter(batches))

    @staticmethod
    def avro(path_glob: str) -> "StreamingReader":
        """One micro-batch per Avro container file, in name order
        (reference StreamingReaders.Simple.avro:43 fileStream)."""
        from ..utils.avro_io import read_avro

        def gen():
            for p in sorted(glob.glob(path_glob)):
                yield read_avro(p)
        return StreamingReader(gen)

    @staticmethod
    def csv(path_glob: str) -> "StreamingReader":
        """One micro-batch per CSV file, in name order."""
        from .data_readers import CSVAutoReader

        def gen():
            for p in sorted(glob.glob(path_glob)):
                yield CSVAutoReader(p).read_records()
        return StreamingReader(gen)

    @staticmethod
    def tail_directory(path_glob: str, poll_interval_s: float = 1.0,
                       idle_timeout_s: Optional[float] = None,
                       fmt: str = "auto",
                       on_error: str = "raise") -> "StreamingReader":
        """LIVE directory tail: yield one micro-batch per NEW file
        matching ``path_glob`` as it appears, polling every
        ``poll_interval_s`` — the continuous-source behavior of the
        reference's DStream fileStream (StreamingReader.scala:54),
        which r3's static listing did not have. Files present at start
        are emitted first (in name order); the stream then keeps
        polling until ``idle_timeout_s`` passes with no new file
        (None = tail forever, like a DStream until its context stops).
        ``fmt``: "avro" | "csv" | "auto" (by extension).
        ``on_error``: "raise" stops the stream on an unreadable file
        (the reference's stop-on-error); "skip" logs it, marks it
        consumed, and keeps tailing."""
        import logging
        import time as _time
        if on_error not in ("raise", "skip"):
            raise ValueError("on_error must be 'raise' or 'skip'")
        log = logging.getLogger(__name__)

        def _read(path: str) -> List[dict]:
            kind = fmt
            if kind == "auto":
                kind = "avro" if path.endswith(".avro") else "csv"
            if kind == "avro":
                from ..utils.avro_io import read_avro
                return read_avro(path)
            from .data_readers import CSVAutoReader
            return CSVAutoReader(path).read_records()

        def _stat(p: str):
            try:
                st = os.stat(p)
                return (st.st_size, st.st_mtime_ns)
            except OSError:
                return None

        def gen():
            seen: set = set()
            #: path -> (last observed (size, mtime), first-stable time)
            pending: dict = {}
            last_new = _time.monotonic()
            while True:
                now = _time.monotonic()
                current = sorted(glob.glob(path_glob))
                # bound memory on long tails over high-churn spools:
                # rotated-away files leave the bookkeeping
                live = set(current)
                seen &= live
                for p in list(pending):
                    if p not in live:
                        del pending[p]
                delivered = False
                for p in current:
                    if p in seen:
                        continue
                    sig = _stat(p)
                    if sig is None:
                        continue
                    prev = pending.get(p)
                    if prev is None:
                        # a NEW file resets the idle clock so a complete
                        # file landing just inside the window still gets
                        # its one stabilization interval; subsequent
                        # (size, mtime) churn does NOT reset it, so a
                        # perpetually-growing file cannot hold the
                        # stream open past the timeout
                        last_new = now
                    if prev is None or prev[0] != sig:
                        # first sighting or still growing: the
                        # (size, mtime) must hold for a full poll
                        # interval so a file caught mid-write is not
                        # truncated (DStream mod-time windowing role).
                        # Wall-clock age, not poll count — delivery
                        # passes skip the sleep, so consecutive polls
                        # can be microseconds apart.
                        pending[p] = (sig, now)
                        continue
                    if now - prev[1] < poll_interval_s:
                        continue
                    del pending[p]
                    seen.add(p)
                    last_new = now
                    delivered = True
                    try:
                        batch = _read(p)
                    except Exception:
                        if on_error == "raise":
                            raise
                        log.warning("tail_directory: unreadable file "
                                    "%s skipped", p, exc_info=True)
                        continue
                    yield batch
                if not delivered:
                    # timeout is measured from the last DELIVERY only: a
                    # file that keeps growing (or is touched forever)
                    # stays pending but must not hold the stream open
                    # past the idle window
                    if idle_timeout_s is not None and \
                            _time.monotonic() - last_new > idle_timeout_s:
                        if pending:
                            log.warning(
                                "tail_directory: idle timeout with %d "
                                "never-stabilizing file(s) undelivered: "
                                "%s", len(pending),
                                sorted(pending)[:5])
                        return
                    _time.sleep(poll_interval_s)
        return StreamingReader(gen)


class StreamingReaders:
    """Factory namespace (reference StreamingReaders.scala:43)."""

    class Simple:
        avro = staticmethod(StreamingReader.avro)
        csv = staticmethod(StreamingReader.csv)
        custom = staticmethod(StreamingReader.from_records)
        tail = staticmethod(StreamingReader.tail_directory)
