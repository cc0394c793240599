"""Sharded slab object store, the retention-scale inventory backend
(copy of ``pybitmessage_tpu.storage.slabstore``: the same on-disk
format byte for byte, so a slab directory written by either package is
read by the other).

- **Content-addressed append-only slabs.**  Payload records append to
  a per-shard slab file; nothing is rewritten in place.
- **Sharded by expiry bucket.**  A record lands in the shard for
  ``expires // bucket_seconds``, so TTL purge is a whole-slab drop (a
  few ``unlink`` calls) instead of a ``DELETE`` scan.
- **Metadata-only RAM index.**  ``hash -> (shard, slab, offset,
  taglen, paylen, type, stream, expires)``; lookups, stream catch-up
  enumeration and digest seeding never touch a payload byte.
- **Incremental digest.**  ``attach_digest`` seeds the sync digest
  from the RAM index and keeps it in step on add and clean, as
  ``Inventory.attach_digest`` does.
- **Pinned hot set.**  Recently added payloads stay in RAM (a
  byte-budgeted LRU), so fresh objects are served without disk I/O.
- **Crash-safe write-behind.**  Appends buffer in RAM and drain to the
  slab file behind the ``storage.slab_io`` chaos site; a failed drain
  keeps every record buffered and readable for the next attempt.
  Sealing a full slab writes a sidecar ``.idx`` (fsynced) before the
  rename, so a restart adopts sealed slabs from their index files and
  replays only the one unsealed slab per shard, tolerating a torn tail.

Record: ``hash(32) type(4) stream(4) expires(8) taglen(2) paylen(4)``
big-endian, then the tag and the payload.  Files: ``<root>/<bucket>/
<no:08d>.open`` while a slab is written, ``.slab`` once sealed, beside
``<no:08d>.idx`` (``BMSLABIDX1\n`` then one row per record: the header
fields and the record's offset, ``>32sLLQHLQ``).

Interface-compatible with :class:`storage.inventory.Inventory`
(``inventorystorage = slab``); with ``root=None`` everything stays in
RAM.  ``clock`` (default ``time.time``) drives TTL, so a test or a
benchmark runs compaction cycles without waiting out bucket windows.
"""

from __future__ import annotations

import logging
import os
import struct
import threading
import time
import weakref
from collections import OrderedDict
from pathlib import Path
from typing import Iterable

from ..models.constants import EXPIRES_GRACE
from ..observability import REGISTRY
from ..resilience.chaos import ChaosError, inject
from ..resilience.policy import ERRORS
from .inventory import ITEMS, InventoryItem

logger = logging.getLogger("pybitmessage_tpu_torch.storage")

#: slab record header: hash(32) type(4) stream(4) expires(8) taglen(2)
#: paylen(4) — tag and payload bytes follow back to back
_REC = struct.Struct(">32sLLQHL")
#: sidecar index row: record header fields + absolute record offset
_IDX = struct.Struct(">32sLLQHLQ")
#: magic first line of a sidecar index file (versioned)
_IDX_MAGIC = b"BMSLABIDX1\n"

READS = REGISTRY.counter(
    "slab_store_reads_total",
    "Payload reads by source: pinned hot set, open-slab RAM buffer, "
    "or a sealed slab on disk", ("source",))
READ_HOT = READS.labels(source="hot")
READ_RAM = READS.labels(source="ram")
READ_DISK = READS.labels(source="disk")
SEALED = REGISTRY.counter(
    "slab_store_sealed_total", "Slabs sealed (idx written, renamed)")
DROPPED = REGISTRY.counter(
    "slab_store_dropped_slabs_total",
    "Whole slabs dropped by TTL compaction (the DELETE-scan "
    "replacement)")
IO_FAILURES = REGISTRY.counter(
    "slab_store_io_failures_total",
    "Slab drain/seal attempts absorbed by the write-behind buffer "
    "(storage.slab_io chaos + real I/O errors); records stay pending "
    "and retry on the next flush")
OPEN_BYTES = REGISTRY.gauge(
    "slab_store_open_bytes",
    "Write-behind bytes buffered in RAM across all open slabs")
HOT_BYTES = REGISTRY.gauge(
    "slab_store_hot_bytes", "Payload bytes pinned in the hot set")

#: index-tuple field offsets (hash -> this tuple is the whole RAM cost
#: per retained object)
_BUCKET, _NO, _OFF, _TAGLEN, _PAYLEN, _TYPE, _STREAM, _EXPIRES = range(8)


class _OpenSlab:
    """One shard's active slab, as three readable layers:

    ``[0, durable)``                       on disk;
    ``[durable, durable+len(staged))``     handed to the drainer — a
                                           frozen segment mid-write
                                           (or awaiting retry);
    ``[.., +len(buf))``                    the live append tail.

    ``add`` only ever touches ``buf``; the background drainer freezes
    ``buf`` into ``staged``, writes it, then advances ``durable`` —
    so the caller's thread (usually the event loop) never does disk
    I/O and every byte stays readable throughout.
    """

    __slots__ = ("no", "durable", "staged", "buf", "hashes")

    def __init__(self, no: int):
        self.no = no
        self.durable = 0            # bytes safely in the slab file
        self.staged = b""           # frozen segment being drained
        self.buf = bytearray()      # live write-behind tail
        self.hashes: list[bytes] = []

    @property
    def size(self) -> int:
        return self.durable + len(self.staged) + len(self.buf)

    @property
    def pending(self) -> int:
        return len(self.staged) + len(self.buf)


def _drainer_main(ref, event) -> None:
    """Drainer thread body: holds only a weakref so an abandoned
    store gets collected and its drainer exits within a second."""
    while True:
        fired = event.wait(1.0)
        store = ref()
        if store is None:
            return
        if fired:
            event.clear()
            store._drain_pending()
        store = None                # release between waits


class SlabStore:
    """Dict-like object store keyed by 32-byte inventory hash."""

    def __init__(self, root: str | Path | None = None, *,
                 slab_max_bytes: int = 4 << 20,
                 bucket_seconds: int = 3600,
                 hot_bytes: int = 8 << 20,
                 drain_bytes: int = 256 << 10,
                 clock=time.time):
        self.root = Path(root) if root is not None else None
        #: injectable clock: bench/tests drive TTL compaction cycles
        #: deterministically instead of waiting out bucket windows
        self._clock = clock
        self.slab_max_bytes = max(int(slab_max_bytes), 1 << 12)
        self.bucket_seconds = max(int(bucket_seconds), 1)
        self.hot_budget = max(int(hot_bytes), 0)
        self.drain_bytes = max(int(drain_bytes), 1 << 12)
        self._lock = threading.RLock()
        #: hash -> (bucket, slab_no, offset, taglen, paylen, type,
        #: stream, expires) — the metadata-only index
        self._index: dict[bytes, tuple] = {}
        #: bucket -> active slab
        self._open: dict[int, _OpenSlab] = {}
        #: (bucket, no) -> hashes — per-sealed-slab membership so a
        #: whole-slab drop removes its index entries without a scan
        self._sealed: dict[tuple[int, int], list[bytes]] = {}
        #: (bucket, no) -> _OpenSlab for slabs sealed but not yet
        #: finalized (drain remnant + fsync + sidecar + rename still
        #: running, or awaiting retry, in the background) — their RAM
        #: layers stay readable until the rename lands
        self._sealing: dict[tuple[int, int], _OpenSlab] = {}
        self._seal_threads: set = set()
        #: keys whose finalize is running RIGHT NOW — flush()'s
        #: synchronous retry must not race a live (join-timed-out)
        #: seal thread onto the same idx/rename
        self._finalizing: set = set()
        #: ALL slab disk writes (drain + finalize) serialize here, off
        #: the caller's thread; the store lock is never held across
        #: file I/O
        self._io_lock = threading.Lock()
        #: buckets whose open slab wants a background drain
        self._drain_wanted: set[int] = set()
        self._drain_event = threading.Event()
        self._drainer: threading.Thread | None = None
        #: after a failed drain, don't re-request before this
        #: monotonic instant — a dead disk must not be retried (and
        #: warned about) once per received object
        self._drain_retry_at = 0.0
        #: RAM copies of sealed slabs when root=None (memory mode)
        self._mem_sealed: dict[tuple[int, int], bytes] = {}
        #: pinned hot set: hash -> (payload, tag), LRU by byte budget
        self._hot: OrderedDict[bytes, tuple[bytes, bytes]] = OrderedDict()
        self._hot_total = 0
        self.lookups = 0            # interface parity (Inventory)
        self._digest = None
        #: startup recovery stats (kill-and-restart acceptance):
        #: sealed slabs adopted from .idx sidecars vs slabs whose
        #: records had to be replayed byte by byte
        self.recovery = {"sealed_indexed": 0, "replayed": 0,
                         "torn_bytes": 0}
        if self.root is not None:
            self.root.mkdir(parents=True, exist_ok=True)
            self._recover()
        ITEMS.set(len(self._index))

    # -- paths ---------------------------------------------------------------

    def _shard_dir(self, bucket: int) -> Path:
        return self.root / ("%d" % bucket)

    def _slab_path(self, bucket: int, no: int, open_: bool) -> Path:
        return self._shard_dir(bucket) / (
            "%08d.%s" % (no, "open" if open_ else "slab"))

    def _idx_path(self, bucket: int, no: int) -> Path:
        return self._shard_dir(bucket) / ("%08d.idx" % no)

    # -- startup recovery ----------------------------------------------------

    def _recover(self) -> None:
        for shard in sorted(self.root.iterdir()):
            if not shard.is_dir():
                continue
            try:
                bucket = int(shard.name)
            except ValueError:
                continue
            for f in sorted(shard.glob("*.slab")):
                try:
                    no = int(f.stem)
                except ValueError:
                    continue        # stray non-slab file; boot anyway
                idx = self._idx_path(bucket, no)
                if idx.exists() and self._load_idx(bucket, no, idx):
                    self.recovery["sealed_indexed"] += 1
                else:
                    # sealed slab without a readable sidecar (should
                    # not happen — the idx lands before the rename) —
                    # fall back to a tolerant replay
                    self._replay(bucket, no, f, open_=False)
            # every .open slab replays, but only the HIGHEST-numbered
            # one per shard stays the active slab — earlier ones are a
            # crash between seal and finalize: they re-enter _sealing
            # so flush() finishes their idx/rename and clean() can
            # still drop them (leaving them untracked would leak their
            # files and index entries forever)
            opens = []
            for f in sorted(shard.glob("*.open")):
                try:
                    opens.append((int(f.stem), f))
                except ValueError:
                    continue        # stray non-slab file; boot anyway
            for no, f in opens[:-1]:
                self._replay(bucket, no, f, open_=False, sealing=True)
            for no, f in opens[-1:]:
                self._replay(bucket, no, f, open_=True)

    def _load_idx(self, bucket: int, no: int, idx: Path) -> bool:
        try:
            data = idx.read_bytes()
        except OSError:
            return False
        if not data.startswith(_IDX_MAGIC):
            return False
        body = memoryview(data)[len(_IDX_MAGIC):]
        if len(body) % _IDX.size:
            return False
        hashes = []
        for i in range(0, len(body), _IDX.size):
            h, t, s, e, taglen, paylen, off = _IDX.unpack_from(body, i)
            self._index[h] = (bucket, no, off, taglen, paylen, t, s, e)
            hashes.append(h)
        self._sealed[(bucket, no)] = hashes
        return True

    def _replay(self, bucket: int, no: int, path: Path,
                open_: bool, sealing: bool = False) -> None:
        """Scan one slab record by record, tolerating a torn tail
        (the crash window is the last buffered drain)."""
        try:
            data = path.read_bytes()
        except OSError:
            return
        self.recovery["replayed"] += 1
        hashes, off = [], 0
        view = memoryview(data)
        while off + _REC.size <= len(data):
            h, t, s, e, taglen, paylen = _REC.unpack_from(view, off)
            rec_len = _REC.size + taglen + paylen
            if off + rec_len > len(data):
                break               # torn tail: drop the partial record
            self._index[h] = (bucket, no, off, taglen, paylen, t, s, e)
            hashes.append(h)
            off += rec_len
        self.recovery["torn_bytes"] += len(data) - off
        if open_:
            if off < len(data):
                try:
                    with open(path, "r+b") as fh:
                        fh.truncate(off)
                except OSError:
                    logger.warning("could not truncate torn slab %s", path)
            slab = _OpenSlab(no)
            slab.durable = off
            slab.hashes = hashes
            self._open[bucket] = slab
        elif sealing:
            # data is durable in the .open file; finalize (idx +
            # rename) retries on the next flush()
            slab = _OpenSlab(no)
            slab.durable = off
            slab.hashes = hashes
            self._sealing[(bucket, no)] = slab
        else:
            self._sealed[(bucket, no)] = hashes

    # -- write path ----------------------------------------------------------

    def __setitem__(self, hash_: bytes, item: InventoryItem) -> None:
        self.add(hash_, item.type, item.stream, item.payload,
                 item.expires, item.tag)

    def add(self, hash_: bytes, type_: int, stream: int, payload,
            expires: int, tag: bytes = b"") -> None:
        """Append one object.  ``payload`` may be any buffer (the
        zero-copy receive path hands in memoryviews); the append into
        the open slab's RAM tail is its single storage copy."""
        tag = bytes(tag)
        expires = int(expires)
        with self._lock:
            index = self._index
            if hash_ in index:
                return
            bucket = expires // self.bucket_seconds
            slab = self._open.get(bucket)
            if slab is None:
                slab = self._open[bucket] = _OpenSlab(
                    self._next_slab_no(bucket))
            buf = slab.buf
            offset = slab.durable + len(slab.staged) + len(buf)
            buf += _REC.pack(hash_, type_, stream, expires,
                             len(tag), len(payload))
            if tag:
                buf += tag
            buf += payload
            slab.hashes.append(hash_)
            index[hash_] = (bucket, slab.no, offset, len(tag),
                            len(payload), type_, stream, expires)
            self._pin(hash_, payload if isinstance(payload, bytes)
                      else bytes(payload), tag)
            if self._digest is not None:
                self._digest.add(hash_, stream, int(expires))
            # gauge upkeep is batched off the per-add path (a metric
            # op per object is ~10% of the budget at 100k obj/s); the
            # drain/seal/flush/clean boundaries re-sync exactly
            if len(self._index) & 0xFFF == 0:
                ITEMS.set(len(self._index))
            # NO disk I/O on this thread (the event loop calls add per
            # received object; under writeback pressure even a
            # buffered append can block for tens of ms on dirty-page
            # throttling): seal and drain both hand the bytes to
            # background threads
            if slab.size >= self.slab_max_bytes:
                self._seal(bucket, slab)
                self._account_open()
            elif self.root is not None and \
                    len(slab.buf) >= self.drain_bytes and \
                    bucket not in self._drain_wanted and \
                    time.monotonic() >= self._drain_retry_at:
                self._request_drain(bucket)

    def _request_drain(self, bucket: int) -> None:
        """Queue one bucket's open slab for the drainer thread
        (caller holds the store lock)."""
        self._drain_wanted.add(bucket)
        if self._drainer is None or not self._drainer.is_alive():
            self._drainer = threading.Thread(
                target=_drainer_main,
                args=(weakref.ref(self), self._drain_event),
                name="bmtpu-slab-drain", daemon=True)
            self._drainer.start()
        self._drain_event.set()

    def _drain_pending(self) -> None:
        """Drainer thread: work the wanted-bucket queue dry."""
        while True:
            with self._lock:
                if not self._drain_wanted:
                    self._account_open()
                    return
                bucket = self._drain_wanted.pop()
                slab = self._open.get(bucket)
            if slab is not None and not self._drain_slab(bucket, slab):
                with self._lock:
                    self._drain_retry_at = time.monotonic() + 0.5

    def _next_slab_no(self, bucket: int) -> int:
        used = [no for b, no in self._sealed if b == bucket]
        used += [no for b, no in self._sealing if b == bucket]
        slab = self._open.get(bucket)
        if slab is not None:
            used.append(slab.no)
        return max(used, default=-1) + 1

    def _drain_slab(self, bucket: int, slab: _OpenSlab) -> bool:
        """Write-behind drain, staged: freeze the live tail into
        ``staged`` (still readable), append it to the slab file, then
        advance the durable mark.  A failure (chaos or real I/O)
        leaves the segment staged and every record readable — zero
        loss; the next attempt retries it.  Runs on drainer/finalize/
        flush threads only, serialized by ``_io_lock``; the store
        lock is never held across the write."""
        if self.root is None:
            return True
        with self._io_lock:
            with self._lock:
                # the slab may have been dropped by clean() meanwhile
                key = (bucket, slab.no)
                if self._open.get(bucket) is not slab and \
                        self._sealing.get(key) is not slab:
                    return True
                if not slab.staged:
                    if not slab.buf:
                        return True
                    slab.staged = bytes(slab.buf)
                    slab.buf = bytearray()
                staged = slab.staged
                durable = slab.durable
            path = self._slab_path(bucket, slab.no, open_=True)
            try:
                inject("storage.slab_io")
                self._shard_dir(bucket).mkdir(parents=True,
                                              exist_ok=True)
                # a PREVIOUS attempt may have failed mid-write
                # (buffered I/O can flush part of the segment before
                # raising): anything past the durable mark is garbage
                # that would shift every later record offset — cut it
                # before re-appending
                try:
                    size = path.stat().st_size
                except FileNotFoundError:
                    size = 0
                if size != durable:
                    with open(path, "r+b" if size else "wb") as fh:
                        fh.truncate(durable)
                with open(path, "ab") as fh:
                    fh.write(staged)
            except (OSError, ChaosError) as exc:
                IO_FAILURES.inc()
                ERRORS.labels(site="storage.slab_io").inc()
                logger.warning("slab drain failed (kept %d bytes "
                               "staged for retry): %r",
                               len(staged), exc)
                return False
            with self._lock:
                slab.durable += len(staged)
                slab.staged = b""
            return True

    def _seal(self, bucket: int, slab: _OpenSlab) -> None:
        """Seal a full slab: pure bookkeeping on the caller's thread —
        the slab moves from open to sealing (every RAM layer stays
        readable) and a background thread does the rest: remnant
        drain, fsync, sidecar index write, rename ``.open`` ->
        ``.slab``.  Restart reads the sidecar — sealed payloads are
        never replayed; a slab killed mid-finalize is still an
        ``.open`` file and replays.  Any failure keeps the slab
        readable and queued for retry (flush())."""
        if self.root is None:
            # memory mode: freeze the buffer and roll the slab number
            self._mem_sealed[(bucket, slab.no)] = bytes(slab.buf)
            self._sealed[(bucket, slab.no)] = slab.hashes
            del self._open[bucket]
            SEALED.inc()
            return
        key = (bucket, slab.no)
        self._sealing[key] = slab
        del self._open[bucket]
        t = threading.Thread(target=self._finalize_seal, args=(key,),
                             name="bmtpu-slab-seal", daemon=True)
        self._seal_threads.add(t)
        t.start()

    def _finalize_seal(self, key: tuple[int, int]) -> None:
        """The durable whole of a seal, off the caller's thread:
        drain the remnant, fsync, write the sidecar, rename.  File
        I/O runs without the store lock (serialized by ``_io_lock``);
        only the sealing->sealed bookkeeping flip takes it."""
        bucket, no = key
        with self._lock:
            slab = self._sealing.get(key)
            if slab is None or key in self._finalizing:
                # dropped concurrently, or another finalize owns it
                self._seal_threads.discard(threading.current_thread())
                return
            self._finalizing.add(key)
        if not self._drain_slab(bucket, slab):
            with self._lock:        # remnant still staged; flush retries
                self._finalizing.discard(key)
                self._seal_threads.discard(threading.current_thread())
            return
        with self._lock:
            if self._sealing.get(key) is not slab:
                # clean() dropped the shard while we drained: its
                # index entries are gone — nothing left to finalize
                self._finalizing.discard(key)
                self._seal_threads.discard(threading.current_thread())
                return
            idx_rows = bytearray(_IDX_MAGIC)
            for h in slab.hashes:
                loc = self._index[h]
                idx_rows += _IDX.pack(h, loc[_TYPE], loc[_STREAM],
                                      loc[_EXPIRES], loc[_TAGLEN],
                                      loc[_PAYLEN], loc[_OFF])
        open_path = self._slab_path(bucket, no, open_=True)
        idx_path = self._idx_path(bucket, no)
        try:
            with self._io_lock:
                # the io lock can queue for a while under writeback
                # pressure — re-check the shard wasn't TTL-dropped
                # during the wait before touching (recreating!) files
                with self._lock:
                    if self._sealing.get(key) is not slab:
                        self._finalizing.discard(key)
                        self._seal_threads.discard(
                            threading.current_thread())
                        return
                inject("storage.slab_io")
                with open(open_path, "rb") as fh:
                    os.fsync(fh.fileno())
                idx_path.write_bytes(bytes(idx_rows))
                with open(idx_path, "rb") as fh:
                    os.fsync(fh.fileno())
                open_path.rename(self._slab_path(bucket, no,
                                                 open_=False))
        except (OSError, ChaosError) as exc:
            with self._lock:
                gone = key not in self._sealing
                self._finalizing.discard(key)
                self._seal_threads.discard(threading.current_thread())
            if gone:
                # clean() TTL-dropped the shard mid-finalize (unlinked
                # the files under us) — an expected race, not an I/O
                # failure; remove whatever this attempt recreated
                logger.debug("slab finalize raced a TTL drop "
                             "(benign): %r", exc)
                self._drop_files(bucket, no, sealed=True)
                return
            IO_FAILURES.inc()
            ERRORS.labels(site="storage.slab_io").inc()
            logger.warning("slab finalize failed (records stay "
                           "readable in the open file; flush() "
                           "retries): %r", exc)
            return
        with self._lock:
            slab = self._sealing.pop(key, None)
            if slab is not None:
                self._sealed[key] = slab.hashes
                SEALED.inc()
            self._finalizing.discard(key)
            self._seal_threads.discard(threading.current_thread())
        if slab is None:
            # clean() dropped the shard while we were finalizing: the
            # freshly-renamed .slab must not outlive it (dropped off
            # the store lock — _drop_files takes the io lock)
            self._drop_files(bucket, no, sealed=True)

    def flush(self) -> None:
        """Drain every open slab's RAM layers to disk and settle any
        in-flight/failed seal finalizes (write-behind flush;
        chaos-absorbing — failures keep records buffered).  The one
        place slab I/O runs on the calling thread — node shutdown and
        the Cleaner (already off-loop) are the callers."""
        for t in list(self._seal_threads):
            t.join(timeout=10.0)
        with self._lock:
            retry = list(self._sealing)
        for key in retry:           # failed finalizes, synchronously
            self._finalize_seal(key)
        with self._lock:
            items = list(self._open.items())
        for bucket, slab in items:
            self._drain_slab(bucket, slab)
        with self._lock:
            self._account_open()
            HOT_BYTES.set(self._hot_total)
            ITEMS.set(len(self._index))

    def _account_open(self) -> None:
        OPEN_BYTES.set(sum(s.pending for s in self._open.values())
                       + sum(s.pending for s in self._sealing.values()))

    # -- read path -----------------------------------------------------------

    def __contains__(self, hash_: bytes) -> bool:
        with self._lock:
            self.lookups += 1
            return hash_ in self._index

    def __getitem__(self, hash_: bytes) -> InventoryItem:
        with self._lock:
            loc = self._index.get(hash_)
            if loc is None:
                raise KeyError(hash_.hex())
            hot = self._hot.get(hash_)
            if hot is not None:
                READ_HOT.inc()
                self._hot.move_to_end(hash_)
                payload, tag = hot
                return InventoryItem(loc[_TYPE], loc[_STREAM], payload,
                                     loc[_EXPIRES], tag)
            rec = self._read_span(
                loc, loc[_OFF] + _REC.size,
                loc[_TAGLEN] + loc[_PAYLEN])
            tag = bytes(rec[:loc[_TAGLEN]])
            payload = bytes(rec[loc[_TAGLEN]:])
            return InventoryItem(loc[_TYPE], loc[_STREAM], payload,
                                 loc[_EXPIRES], tag)

    def _read_span(self, loc: tuple, offset: int, length: int,
                   count: bool = True):
        """Raw bytes of one span of the record's slab, wherever they
        currently live: live tail / staged drain segment of an open
        or sealing slab, memory-mode sealed copy, or the file on
        disk.  A record never straddles layers: staging freezes the
        whole tail at once and commits it whole."""
        bucket, no = loc[_BUCKET], loc[_NO]
        slab = self._open.get(bucket)
        if slab is None or slab.no != no:
            slab = self._sealing.get((bucket, no))
        if slab is not None and slab.no == no and \
                offset >= slab.durable:
            if count:
                READ_RAM.inc()
            rel = offset - slab.durable
            staged = slab.staged
            if rel < len(staged):
                return memoryview(staged)[rel:rel + length]
            rel -= len(staged)
            return memoryview(slab.buf)[rel:rel + length]
        mem = self._mem_sealed.get((bucket, no))
        if mem is not None:
            if count:
                READ_RAM.inc()
            return memoryview(mem)[offset:offset + length]
        if count:
            READ_DISK.inc()
        sealed = (bucket, no) in self._sealed
        try:
            return self._pread(self._slab_path(bucket, no,
                                               open_=not sealed),
                               offset, length)
        except FileNotFoundError:
            # a background finalize renamed .open -> .slab between the
            # membership check and the open(); the other name has it
            return self._pread(self._slab_path(bucket, no,
                                               open_=sealed),
                               offset, length)

    @staticmethod
    def _pread(path: Path, offset: int, length: int) -> bytes:
        with open(path, "rb") as fh:
            fh.seek(offset)
            return fh.read(length)

    # -- hot set -------------------------------------------------------------

    def _pin(self, hash_: bytes, payload: bytes,
             tag: bytes = b"") -> None:
        """Pin ``(payload, tag)`` — the WHOLE item, so hot reads of
        tagged objects (pubkeys, v5 broadcasts) never touch a slab
        file either."""
        size = len(payload) + len(tag)
        if self.hot_budget <= 0 or size > self.hot_budget:
            return
        self._hot[hash_] = (payload, tag)
        self._hot_total += size
        while self._hot_total > self.hot_budget:
            _h, (dp, dt) = self._hot.popitem(last=False)
            self._hot_total -= len(dp) + len(dt)
        # exported lazily (every 1024 pins + at flush/clean): a gauge
        # set per add is measurable at line rate
        if len(self._hot) & 0x3FF == 0:
            HOT_BYTES.set(self._hot_total)

    def _unpin_all(self, hashes: Iterable[bytes]) -> None:
        for h in hashes:
            dropped = self._hot.pop(h, None)
            if dropped is not None:
                self._hot_total -= len(dropped[0]) + len(dropped[1])
        HOT_BYTES.set(self._hot_total)

    # -- queries (Inventory interface) ---------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._index)

    def by_type_and_tag(self, object_type: int,
                        tag: bytes | None = None) -> list[InventoryItem]:
        # snapshot matches under the lock, read payloads OUTSIDE it —
        # at 10M-object retention a cold tag query is thousands of
        # preads, and holding the store lock across them would stall
        # every connection's duplicate check behind this call
        with self._lock:
            matches = [h for h, loc in self._index.items()
                       if loc[_TYPE] == object_type]
        out = []
        for h in matches:
            try:
                item = self[h]       # takes the lock per item, briefly
            except (KeyError, OSError):
                continue
            if tag is None or item.tag == tag:
                out.append(item)
        return out

    def unexpired_hashes_by_stream(self, stream: int) -> list[bytes]:
        now = int(self._clock())
        with self._lock:
            return [h for h, loc in self._index.items()
                    if loc[_STREAM] == stream and loc[_EXPIRES] > now]

    def hashes(self) -> Iterable[bytes]:
        with self._lock:
            return list(self._index)

    def export_buckets(self, stream: int):
        """Live-handoff export (a relay's ``shardShed``): yields ``(bucket, [hashes])`` pairs covering every unexpired
        record of ``stream``, grouped by expiry bucket — the natural
        resumable transfer unit (an interrupted drain re-sends whole
        buckets; the receiver's hash dedupe absorbs the overlap).
        Hashes snapshot under the lock; the caller reads payloads item
        by item and skips any record TTL-dropped mid-drain."""
        now = int(self._clock())
        with self._lock:
            buckets: dict[int, list[bytes]] = {}
            for h, loc in self._index.items():
                if loc[_STREAM] == stream and loc[_EXPIRES] > now:
                    buckets.setdefault(loc[_BUCKET], []).append(h)
        for bucket in sorted(buckets):
            yield bucket, buckets[bucket]

    def attach_digest(self, digest) -> None:
        """Seed the sync digest from the metadata index — no payload
        read, no table scan — then maintain it incrementally exactly
        like ``Inventory.attach_digest``."""
        with self._lock:
            now = int(self._clock())
            digest.rebuild((h, loc[_STREAM], loc[_EXPIRES])
                           for h, loc in self._index.items()
                           if loc[_EXPIRES] > now)
            self._digest = digest

    # -- TTL compaction ------------------------------------------------------

    def clean(self) -> None:
        """TTL purge as whole-slab drop: a shard whose bucket window
        ended more than the purge grace ago holds only objects every
        backend would have deleted — unlink its slabs and forget its
        index entries, no scan over live objects."""
        now = int(self._clock())
        cutoff_bucket = (now - EXPIRES_GRACE) // self.bucket_seconds
        # lock scope is PER SLAB, not per cycle: at 10M-object scale a
        # compaction forgets millions of index entries, and the
        # Cleaner runs this in a worker thread — one cycle-long hold
        # would block every event-loop duplicate check behind it.
        # File unlinks run off-lock: the entries are already
        # forgotten, so no reader can reach the files (a racing
        # finalize re-drops its own rename, see _finalize_seal).
        with self._lock:
            sealed_keys = [k for k in self._sealed
                           if k[0] < cutoff_bucket]
            sealing_keys = [k for k in self._sealing
                            if k[0] < cutoff_bucket]
            open_buckets = [b for b in self._open if b < cutoff_bucket]
        for key in sealed_keys:
            with self._lock:
                hashes = self._sealed.pop(key, None)
                if hashes is None:
                    continue
                self._mem_sealed.pop(key, None)
                self._forget(hashes)
            self._drop_files(key[0], key[1], sealed=True)
            DROPPED.inc()
        for key in sealing_keys:
            with self._lock:
                slab = self._sealing.pop(key, None)
                if slab is not None:
                    hashes = slab.hashes
                else:
                    # a finalize completed between the snapshot and
                    # this pop: the slab migrated to _sealed — drop it
                    # from there or it would outlive its TTL window
                    hashes = self._sealed.pop(key, None)
                    self._mem_sealed.pop(key, None)
                if hashes is None:
                    continue
                self._forget(hashes)
            self._drop_files(key[0], key[1], sealed=slab is None)
            DROPPED.inc()
        for bucket in open_buckets:
            with self._lock:
                slab = self._open.pop(bucket, None)
                if slab is None:
                    continue
                no = slab.no
                self._forget(slab.hashes)
            self._drop_files(bucket, no, sealed=False)
            DROPPED.inc()
        with self._lock:
            if self._digest is not None:
                # expired objects must leave the announce view NOW,
                # not when their whole shard becomes droppable
                self._digest.clean(now)
            self._account_open()
            ITEMS.set(len(self._index))

    def _drop_files(self, bucket: int, no: int, sealed: bool) -> None:
        if self.root is None:
            return
        # under the io lock: an in-flight drain racing this unlink
        # would otherwise recreate the file AFTER it (its membership
        # re-check runs inside the io lock, so serializing here makes
        # either ordering safe).  Callers must not hold the store
        # lock (io lock is always the outer of the two).
        with self._io_lock:
            # unlink BOTH slab names: a background finalize may rename
            # .open -> .slab between the caller's membership check and
            # this unlink (the finalize itself re-drops on that race)
            for path in (self._slab_path(bucket, no, open_=not sealed),
                         self._slab_path(bucket, no, open_=sealed),
                         self._idx_path(bucket, no)):
                try:
                    path.unlink(missing_ok=True)
                except OSError as exc:
                    ERRORS.labels(site="storage.slab_io").inc()
                    logger.warning("dropping slab file %s failed: %r",
                                   path, exc)
            try:
                self._shard_dir(bucket).rmdir()
            except OSError:
                pass                # shard still holds other slabs

    def _forget(self, hashes: list[bytes]) -> None:
        for h in hashes:
            self._index.pop(h, None)
        self._unpin_all(hashes)
