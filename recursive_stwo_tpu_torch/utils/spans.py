"""Spans: named host ranges of the port, on the profiler's clock.

`span(name)` is a context manager that opens the range PREFIX + name through
torch's `_RecordFunctionFast`.  It records only while a torch profiler is
recording (`torch.profiler.profile` with CPU activity); otherwise it costs
one object and one check of the profiler's state.  The profiler keeps the
ranges in memory and puts them on the clock of the card's events, so each
stretch in which the card idles can be put down to what the host was doing.

The range has function scope.  A `record_function` range has user scope,
and the profiler copies it onto the card's timeline as a
`gpu_user_annotation` of CUDA device type, which a reader of the trace would
count as work on the card; a span has no such copy.

Spans nest on the one host thread: the spans of a `prove` or `verify_batch`
call are those inside it.  Counts are span occurrences: `to_host` is opened
at every read from the card to the host in the prover.  A span never
synchronizes, never reads a tensor and changes no result.

The names (the contract the benchmark's readers and PERF.md use):
  prove.air, prove.upload                  the AIR columns built, uploaded
  prove.interaction                        the interaction columns generated
                                           and interpolated, every table
  prove.composition                        the composition stage, every table
  tree.commit                              every Merkle tree built
  stream.chunk, stream.host_levels,        a streamed tree's chunks, its top
  stream.recompute                         levels on the host, a decommit's span
  sha256.level                             a SHA-256 tree level (a block's part)
  fri.layers > fri.first_tree, fri.fold,   the FRI commit stage, from the
    fri.layer_tree, channel.mix_root,      first-layer quotients to the last
    channel.draw, fri.last_layer           layer's felts mixed
  fri.grind, fri.queries                   the PoW grind, the query draws
  fri.decommit > decommit.plan,            the decommitments: host index plans
    decommit.gather                        and the gathers with their copies
  to_host                                  a read from the card to the host
  verify.transcript, verify.composition,   verify_batch's phases
  verify.fold > fold.prepare,
    verify.walk_jobs
  verify.hash > hash.absorb_lower,         the hash phase: op tables lowered,
    hash.leaf, hash.walk_lower, hash.scan  the leaf permutation, the scans
"""

from __future__ import annotations

from torch._C._profiler import _RecordFunctionFast

PREFIX = "rstpu."


def span(name: str) -> _RecordFunctionFast:
    """The range PREFIX + name, for a `with` block."""
    return _RecordFunctionFast(PREFIX + name)
