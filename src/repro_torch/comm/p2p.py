"""Point-to-point rounds over ``torch.distributed`` — the port's
counterpart of ``shard_map`` + ``lax.ppermute``.

The JAX package runs its collectives as one SPMD program over a device
mesh; here every rank is a process of a ``torch.distributed`` group:

* :func:`spawn` — the counterpart of
  ``--xla_force_host_platform_device_count``: starts ``world_size``
  processes (the ``spawn`` start method, which CUDA needs), joins them in
  one gloo group at ``tcp://localhost:<free port>``, runs ``fn(rank,
  *args)`` in each and returns the ranks' results in rank order. A rank
  that raises fails the call.
* :func:`ppermute` — one round of ``lax.ppermute`` as one
  ``dist.batch_isend_irecv``: a rank sends at most once and receives at
  most once (the collective-permute rule); destinations get the sender's
  value, every other rank keeps its own.
* :data:`LOG` — this process's send log: one ``(round, src, dst,
  nbytes)`` entry per message it sent or received, the bytes it staged
  between the card and the host, and the host time it spent in rounds.
* :func:`reduce_scatter` / :func:`all_gather` — the two gloo
  collectives of the hierarchical all-reduce, tiled along dim 0 as
  ``lax.psum_scatter(..., tiled=True)`` / ``lax.all_gather(...,
  tiled=True)``, on the same transport. Inside a recorded sweep
  (``core.exec_ir.record``) each reports itself: a collective there is
  a stray one, which the executed-communication verifier flags.

**The card's transport.** gloo moves host memory: it reads a tensor
through its data pointer on the host. It does not refuse a CUDA tensor
in ``send`` or ``batch_isend_irecv``: it hands the device pointer to
``writev``, which fails with "Bad address", and the sender aborts (seen
with torch 2.11 and gloo's TCP transport on an H100 host). In a gloo
group a CUDA tensor is therefore staged explicitly through reused pinned
host buffers, device → pinned → gloo → pinned → device. The compute
stays on the card, every staged byte is counted in :data:`LOG`, and
nothing moves to the host unless a rank's message does. gloo is the
default, and the PSelInv ranked sweeps stay on it: their eight ranks
share one card.

``backend="nccl"`` runs one rank a card (``torch.cuda.set_device(rank)``)
and passes CUDA tensors straight to NCCL — no staging, so
``LOG.staged_bytes`` stays 0, while every message is logged as on gloo.
NCCL refuses two ranks on one card: :func:`spawn` raises when the world
is larger than the card count, and on a host without NCCL or a card.

Group coordinates: ``perm`` pairs are ranks of ``group`` (the default
group when None); the log records global ranks."""
from __future__ import annotations

import os
import pickle
import queue
import socket
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..core import exec_ir

__all__ = ["SendLog", "LOG", "spawn", "ppermute", "reduce_scatter",
           "all_gather", "global_rank"]

@dataclass
class SendLog:
    """What this process moved: ``entries`` holds ``(round, src, dst,
    nbytes)`` for every message it sent (``src`` is this rank) or
    received (``dst`` is this rank), in global ranks; ``rounds`` counts
    :func:`ppermute` calls, so every rank of a group numbers a round
    alike; ``staged_bytes`` counts the bytes copied between the card and
    the pinned host buffers, both ways; ``wait_s`` the host seconds spent
    inside rounds and collectives, of which ``sync_s`` waiting for the
    card to finish the work queued before a payload's staging copy (the
    rest is the copies and the wire)."""
    rounds: int = 0
    entries: List[Tuple[int, int, int, int]] = field(default_factory=list)
    staged_bytes: int = 0
    wait_s: float = 0.0
    sync_s: float = 0.0

    def clear(self) -> None:
        self.rounds, self.staged_bytes = 0, 0
        self.wait_s = self.sync_s = 0.0
        self.entries.clear()

    def sent(self, rank: Optional[int] = None) -> Tuple[int, int]:
        """(messages, bytes) ``rank`` sent — this process's global rank
        by default."""
        me = dist.get_rank() if rank is None else rank
        m = [n for _, s, _, n in self.entries if s == me]
        return len(m), sum(m)

    def received(self, rank: Optional[int] = None) -> Tuple[int, int]:
        me = dist.get_rank() if rank is None else rank
        m = [n for _, _, d, n in self.entries if d == me]
        return len(m), sum(m)

    def snapshot(self, rank: Optional[int] = None) -> dict:
        """This log as a plain dict (``rank``, ``entries``, ``rounds``,
        ``staged_bytes``) — what ``core.exec_verify.lint_ranked`` reads
        once the ranks' logs are gathered."""
        return dict(rank=dist.get_rank() if rank is None else rank,
                    entries=list(self.entries), rounds=self.rounds,
                    staged_bytes=self.staged_bytes)


#: this process's send log (zero it with ``LOG.clear()`` right before the
#: rounds it should count)
LOG = SendLog()

# pinned host buffers by role and dtype, grown to the largest message,
# each with the event of the last copy that still reads it
_buffers: Dict[Tuple[str, torch.dtype], List] = {}


def global_rank(group, rank: int) -> int:
    """The global rank of ``group``'s rank ``rank``."""
    if group is None or group is dist.group.WORLD:
        return rank
    return dist.get_global_rank(group, rank)


def _staged(group) -> bool:
    """Whether ``group``'s transport needs CUDA payloads staged on the
    host: gloo does, NCCL takes device memory."""
    backend = dist.get_backend(group)
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"unknown backend {backend!r}")
    return backend == "gloo"


def _pinned(role: str, dtype: torch.dtype, numel: int) -> torch.Tensor:
    """A pinned host buffer of ``numel`` elements, reused across calls;
    waits for the last copy out of it to finish before handing it out."""
    slot = _buffers.get((role, dtype))
    if slot is None or slot[0].numel() < numel:
        slot = [torch.empty(numel, dtype=dtype, pin_memory=True), None]
        _buffers[(role, dtype)] = slot
    elif slot[1] is not None:
        slot[1].synchronize()
        slot[1] = None
    return slot[0][:numel]


def _to_host(role: str, x: torch.Tensor) -> torch.Tensor:
    """``x`` as flat host memory gloo can read: itself on the host; on
    the card a copy into a pinned buffer (a blocking copy, so it holds
    the values the stream computed)."""
    if x.device.type != "cuda":
        return x.contiguous().view(-1)
    t0 = time.perf_counter()
    torch.cuda.current_stream(x.device).synchronize()
    LOG.sync_s += time.perf_counter() - t0
    buf = _pinned(role, x.dtype, x.numel())
    with exec_ir.staging():
        buf.copy_(x.reshape(-1))
    LOG.staged_bytes += x.numel() * x.element_size()
    return buf


def _host_buffer(role: str, like: torch.Tensor, numel: int) -> torch.Tensor:
    """Flat host memory for ``numel`` elements gloo writes into:
    pinned and reused when the result goes to the card."""
    if like.device.type != "cuda":
        return torch.empty(numel, dtype=like.dtype)
    return _pinned(role, like.dtype, numel)


def _to_device(role: str, h: torch.Tensor, like: torch.Tensor,
               shape) -> torch.Tensor:
    """Host result ``h`` shaped ``shape`` on ``like``'s device: the
    pinned buffer copied up asynchronously, its event kept so the buffer
    is not refilled before the copy has read it."""
    if like.device.type != "cuda":
        return h.view(shape)
    out = torch.empty(shape, dtype=like.dtype, device=like.device)
    with exec_ir.staging():
        out.view(-1).copy_(h, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    _buffers[(role, like.dtype)][1] = ev
    LOG.staged_bytes += h.numel() * h.element_size()
    return out


def ppermute(x: torch.Tensor, perm: Sequence[Tuple[int, int]],
             group=None) -> torch.Tensor:
    """One round of ``lax.ppermute(x, perm)`` over ``group``: each (src,
    dst) pair sends src's ``x`` to dst, as one ``batch_isend_irecv``. A
    rank sends at most once and receives at most once; a destination
    returns the value it received, every other rank its own ``x``, and a
    rank outside ``perm`` moves nothing. Every rank of the group calls it
    for every round (the round number in :data:`LOG` counts calls). On
    gloo a CUDA ``x`` is staged through pinned host buffers; NCCL moves
    it as it is."""
    staged = _staged(group)
    me, size = dist.get_rank(group), dist.get_world_size(group)
    pairs = [(int(s), int(d)) for s, d in perm]
    srcs, dsts = [s for s, _ in pairs], [d for _, d in pairs]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"perm {pairs}: a rank sends or receives twice "
                         "in one round")
    if any(not 0 <= r < size for r in srcs + dsts) or any(
            s == d for s, d in pairs):
        raise ValueError(f"perm {pairs}: ranks must be distinct members "
                         f"of a group of {size}")
    rnd = LOG.rounds
    LOG.rounds += 1
    to = [d for s, d in pairs if s == me]
    frm = [s for s, d in pairs if d == me]
    if not to and not frm:
        return x
    t0 = time.perf_counter()
    nbytes = x.numel() * x.element_size()
    gme = global_rank(group, me)
    ops = []
    if to:
        peer = global_rank(group, to[0])
        ops.append(dist.P2POp(dist.isend, _to_host("send", x) if staged
                              else x.contiguous(), peer, group))
        LOG.entries.append((rnd, gme, peer, nbytes))
    if frm:
        peer = global_rank(group, frm[0])
        rbuf = (_host_buffer("recv", x, x.numel()) if staged
                else torch.empty_like(x, memory_format=torch.contiguous_format))
        ops.append(dist.P2POp(dist.irecv, rbuf, peer, group))
        LOG.entries.append((rnd, peer, gme, nbytes))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if not frm:
        out = x
    else:
        out = _to_device("recv", rbuf, x, x.shape) if staged else rbuf
    LOG.wait_s += time.perf_counter() - t0
    return out


def reduce_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.psum_scatter(x, axis, scatter_dimension=0, tiled=True)``:
    the group's sum of ``x``, split along dim 0 into group-size tiles,
    rank i keeping tile i. ``x.shape[0]`` must divide evenly."""
    staged = _staged(group)
    rec = exec_ir.active()
    if rec is not None:
        rec.collective("reduce-scatter", x)
    n = dist.get_world_size(group)
    if x.shape[0] % n:
        raise ValueError(f"leading dim {x.shape[0]} is not divisible by "
                         f"the group size {n}")
    t0 = time.perf_counter()
    shape = (x.shape[0] // n,) + x.shape[1:]
    if staged:
        h = _to_host("rs_in", x)
        out = _host_buffer("rs_out", x, h.numel() // n)
        dist.reduce_scatter(out, list(h.chunk(n)), group=group)
        res = _to_device("rs_out", out, x, shape)
    else:
        res = torch.empty(shape, dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(res, x.contiguous(), group=group)
    LOG.wait_s += time.perf_counter() - t0
    return res


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.all_gather(x, axis, axis=0, tiled=True)``: every rank's
    ``x`` concatenated along dim 0 in rank order."""
    staged = _staged(group)
    rec = exec_ir.active()
    if rec is not None:
        rec.collective("all-gather", x)
    n = dist.get_world_size(group)
    t0 = time.perf_counter()
    shape = (x.shape[0] * n,) + x.shape[1:]
    if staged:
        h = _to_host("ag_in", x)
        out = _host_buffer("ag_out", x, h.numel() * n)
        dist.all_gather(list(out.chunk(n)), h, group=group)
        res = _to_device("ag_out", out, x, shape)
    else:
        res = torch.empty(shape, dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(res, x.contiguous(), group=group)
    LOG.wait_s += time.perf_counter() - t0
    return res


# ---- the launcher ----------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@dataclass
class _Failed:
    """A rank's own traceback, sent ahead of its exit so the parent can
    name the first fault and not the connection errors it causes."""
    trace: str


def _entry(rank: int, world_size: int, init_method: str, backend: str,
           work, results) -> None:
    """One rank: take ``fn`` and its arguments, join the group, run
    ``fn``, hand its result back."""
    fn, args = pickle.loads(work.get())
    # all ranks share this host: gloo talks over the loopback interface
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    try:
        out = fn(rank, *args)
        dist.barrier()
    except BaseException:
        results.put((rank, _Failed(traceback.format_exc())))
        raise
    finally:
        dist.destroy_process_group()
    results.put((rank, out))


def _first_failure(results, timeout: float) -> Optional[str]:
    """The first rank traceback on the queue within ``timeout`` s."""
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        try:
            rank, val = results.get(timeout=0.1)
        except queue.Empty:
            continue
        if isinstance(val, _Failed):
            return f"rank {rank} failed:\n{val.trace}"
    return None


def _check_nccl(world_size: int) -> None:
    """Raise unless this host can run ``world_size`` NCCL ranks, one a
    card."""
    if not dist.is_nccl_available():
        raise RuntimeError("backend='nccl': this torch has no NCCL")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if world_size > cards:
        raise RuntimeError(f"backend='nccl' runs one rank a card: "
                           f"{world_size} ranks, {cards} cards (NCCL "
                           "refuses two ranks on one card)")


def spawn(fn: Callable, world_size: int, *args, backend: str = "gloo",
          timeout: Optional[float] = None) -> list:
    """Run ``fn(rank, *args)`` in ``world_size`` new processes joined in
    one ``backend`` group, and return their results in rank order. ``fn``
    and its arguments are pickled once (``fn`` by import path) and sent
    through a queue once the processes run — as process arguments, a
    large array would start the ranks one after another, each waiting for
    the last to import torch and read it; the results come back through
    a queue. A rank that raises fails the call with its
    traceback, and the other ranks are stopped; so are all of them past
    ``timeout`` seconds (``TimeoutError``). A rank on the card calls
    ``torch.cuda.set_device`` before it allocates; build the CUDA kernels
    in the parent first, so the ranks load them instead of racing to
    build them. ``backend="nccl"`` puts rank r on card r (``set_device``
    before the group starts)."""
    if backend == "nccl":
        _check_nccl(world_size)
    elif backend != "gloo":
        raise ValueError(f"unknown backend {backend!r}")
    import torch.multiprocessing as mp

    from multiprocessing.reduction import ForkingPickler

    work = mp.get_context("spawn").Queue()
    results = mp.get_context("spawn").Queue()
    ctx = mp.start_processes(
        _entry, args=(world_size, f"tcp://localhost:{_free_port()}",
                      backend, work, results),
        nprocs=world_size, join=False, start_method="spawn")
    blob = bytes(ForkingPickler.dumps((fn, args)))
    for _ in range(world_size):
        work.put(blob)
    deadline = None if timeout is None else time.monotonic() + timeout
    out: Dict[int, object] = {}
    try:
        done = False
        while len(out) < world_size:
            try:        # drain the queue before joining its writers
                rank, val = results.get(timeout=0.2)
            except queue.Empty:
                pass
            else:
                if isinstance(val, _Failed):
                    raise RuntimeError(f"rank {rank} failed:\n{val.trace}")
                out[rank] = val
                continue
            if done:
                break
            try:
                done = ctx.join(timeout=0)      # raises if a rank failed
            except (mp.ProcessRaisedException,
                    mp.ProcessExitedException) as e:
                first = _first_failure(results, 2.0)
                raise RuntimeError(first or str(e)) from e
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"spawn: {world_size} ranks did not "
                                   f"finish in {timeout} s")
        while not ctx.join(timeout=0.2):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"spawn: {world_size} ranks did not "
                                   f"exit in {timeout} s")
    finally:
        work.cancel_join_thread()    # a rank that died left its share
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join()
    missing = sorted(set(range(world_size)) - set(out))
    if missing:
        raise RuntimeError(f"spawn: ranks {missing} exited without a "
                           "result")
    return [out[r] for r in range(world_size)]
