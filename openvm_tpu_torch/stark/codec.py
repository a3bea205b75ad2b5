"""Proof serialization codec, byte-aligned with the reference.

Copy of openvm_tpu/stark/codec.py:1-287, so that both packages give the same
bytes for the same proof.  It matches
``crates/sdk/src/codec.rs`` (reference) field-for-field:

* header: ``CODEC_VERSION`` u32 LE = 1 (codec.rs:27,103)
* field elements: canonical u32 LE (codec.rs:309-313); digests: 8 field
  elements with no length prefix (codec.rs:291-298)
* slices: u32 LE length followed by elements (codec.rs:301-307,315-320)
* Proof = commitments (main_trace slice, after_challenge slice, quotient
  digest), OpeningProof (FRI proof THEN opened values), per_air slice,
  RapPhaseSeqKind byte, logup pow witness (codec.rs:102-121)
* ``AdjacentOpenedValues`` = local slice then next slice, EACH with its
  own length prefix (codec.rs:170-176)
* ``AirProofData`` carries ``degree`` (the trace height), not log_degree
  (codec.rs:188-197)
* the FRI proof nests exactly as codec.rs:201-258 (commit-phase commits,
  query proofs, final poly, pow witness; query proof = input batches then
  commit-phase steps)
* ``Option<FriLogUpPartialProof>``: pow witness u32, or u32::MAX for None
  (codec.rs:261-270)

``air_perm_by_height`` is NOT part of the encoding (the reference proof
derives AIR ordering from per-air degrees); decode reconstructs it with
the prover's rule (stable sort by decreasing log_degree).

The one value this environment cannot pin: ``RapPhaseSeqKind::FriLogUp as
u8`` lives in the un-vendored stark-backend crate; we use 0 (first
variant).  Tracked in BITCOMPAT.md.
"""

from __future__ import annotations

import struct

import numpy as np

from . import prover as pv
from .. import fri as fri_mod
from ..field import babybear as _bb

_P = _bb.P

CODEC_VERSION = 1
RAP_PHASE_SEQ_KIND_FRI_LOG_UP = 0  # stark-backend RapPhaseSeqKind::FriLogUp
_U32_MAX = 0xFFFFFFFF


def _w_u32(out, v):
    out.append(struct.pack("<I", int(v) & _U32_MAX))


def _w_len(out, n):
    _w_u32(out, n)


def _w_digest(out, d):
    for x in np.asarray(d, dtype=np.uint64):
        _w_u32(out, x)


def _w_ext(out, e):
    for x in e:
        _w_u32(out, x)


def _w_ext_slice(out, vs):
    _w_len(out, len(vs))
    for v in vs:
        _w_ext(out, v)


def _w_adjacent(out, ao):
    # codec.rs:170-176 — local and next each length-prefixed
    _w_ext_slice(out, ao.local)
    _w_ext_slice(out, ao.next)


def encode_proof(proof) -> bytes:
    out: list[bytes] = []
    _w_u32(out, CODEC_VERSION)

    # commitments (codec.rs:104-108)
    c = proof.commitments
    _w_len(out, len(c.main_trace))
    for d in c.main_trace:
        _w_digest(out, d)
    _w_len(out, len(c.after_challenge))
    for d in c.after_challenge:
        _w_digest(out, d)
    _w_digest(out, c.quotient)

    # OpeningProof: FRI proof first (codec.rs:131-139)
    fp = proof.opening.proof
    _w_len(out, len(fp.commit_phase_commits))
    for d in fp.commit_phase_commits:
        _w_digest(out, d)
    _w_len(out, len(fp.query_proofs))
    for qp in fp.query_proofs:
        # input_proof: Vec<BatchOpening> (codec.rs:241-251)
        _w_len(out, len(qp.input_proof))
        for batch in qp.input_proof:
            _w_len(out, len(batch.opened_values))
            for row in batch.opened_values:
                _w_len(out, len(row))
                for v in row:
                    _w_u32(out, v)
            _w_len(out, len(batch.opening_proof))
            for d in batch.opening_proof:
                _w_digest(out, d)
        # commit_phase_openings (codec.rs:252-257)
        _w_len(out, len(qp.commit_phase_openings))
        for step in qp.commit_phase_openings:
            _w_ext(out, step.sibling_value)
            _w_len(out, len(step.opening_proof))
            for d in step.opening_proof:
                _w_digest(out, d)
    _w_ext_slice(out, fp.final_poly)
    _w_u32(out, fp.pow_witness)

    # opened values (codec.rs:146-168)
    vals = proof.opening.values
    _w_len(out, len(vals.preprocessed))
    for ao in vals.preprocessed:
        _w_adjacent(out, ao)
    _w_len(out, len(vals.main))
    for mats in vals.main:
        _w_len(out, len(mats))
        for ao in mats:
            _w_adjacent(out, ao)
    _w_len(out, len(vals.after_challenge))
    for mats in vals.after_challenge:
        _w_len(out, len(mats))
        for ao in mats:
            _w_adjacent(out, ao)
    _w_len(out, len(vals.quotient))
    for chunks in vals.quotient:
        _w_len(out, len(chunks))
        for chunk in chunks:
            _w_ext_slice(out, chunk)

    # per_air (codec.rs:114,188-197): degree, not log_degree
    _w_len(out, len(proof.per_air))
    for p in proof.per_air:
        _w_u32(out, p.air_id)
        _w_u32(out, 1 << p.log_degree)
        _w_len(out, len(p.exposed_values_after_challenge))
        for phase in p.exposed_values_after_challenge:
            _w_ext_slice(out, phase)
        _w_len(out, len(p.public_values))
        for v in p.public_values:
            _w_u32(out, v)

    # RAP phase kind + logup pow witness (codec.rs:116-118,261-270)
    out.append(bytes([RAP_PHASE_SEQ_KIND_FRI_LOG_UP]))
    if proof.commitments.after_challenge:
        _w_u32(out, proof.log_up_pow_witness)
    else:
        _w_u32(out, _U32_MAX)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def u32(self) -> int:
        v = struct.unpack_from("<I", self.data, self.pos)[0]
        self.pos += 4
        return v

    def felt(self) -> int:
        """Canonical field element: the reference decodes via
        F::from_canonical_u32, which rejects values >= P — accepting
        non-canonical encodings would make distinct byte strings decode
        to the same proof (malleability)."""
        v = self.u32()
        if v >= _P:
            raise CodecError(f"non-canonical field element {v}")
        return v

    def byte(self) -> int:
        v = self.data[self.pos]
        self.pos += 1
        return v

    def digest(self):
        return np.asarray([self.felt() for _ in range(8)], dtype=np.uint64)

    def ext(self):
        return tuple(self.felt() for _ in range(4))

    def ext_slice(self):
        return [self.ext() for _ in range(self.u32())]

    def adjacent(self):
        local = self.ext_slice()
        nxt = self.ext_slice()
        return pv.AdjacentOpenedValues(local=local, next=nxt)


class CodecError(ValueError):
    pass


def decode_proof(data: bytes):
    r = _Reader(data)
    version = r.u32()
    if version != CODEC_VERSION:
        raise CodecError(f"invalid codec version: expected {CODEC_VERSION}, "
                         f"got {version}")

    main_trace = [r.digest() for _ in range(r.u32())]
    after = [r.digest() for _ in range(r.u32())]
    quotient_c = r.digest()

    cpc = [r.digest() for _ in range(r.u32())]
    qps = []
    for _ in range(r.u32()):
        input_proof = []
        for _ in range(r.u32()):
            rows = [[r.felt() for _ in range(r.u32())]
                    for _ in range(r.u32())]
            path = [r.digest() for _ in range(r.u32())]
            input_proof.append(fri_mod.BatchOpening(
                opened_values=rows, opening_proof=path))
        steps = []
        for _ in range(r.u32()):
            sib = r.ext()
            path = [r.digest() for _ in range(r.u32())]
            steps.append(fri_mod.CommitPhaseStep(
                sibling_value=sib, opening_proof=path))
        qps.append(fri_mod.QueryProof(input_proof=input_proof,
                                      commit_phase_openings=steps))
    final_poly = r.ext_slice()
    fri_pow = r.felt()

    prep = [r.adjacent() for _ in range(r.u32())]
    main = [[r.adjacent() for _ in range(r.u32())] for _ in range(r.u32())]
    after_vals = [[r.adjacent() for _ in range(r.u32())]
                  for _ in range(r.u32())]
    quotient_vals = [[r.ext_slice() for _ in range(r.u32())]
                     for _ in range(r.u32())]

    per_air = []
    for _ in range(r.u32()):
        air_id = r.u32()
        degree = r.u32()
        if degree == 0 or degree & (degree - 1):
            raise CodecError(f"air degree {degree} is not a power of two")
        exposed = [r.ext_slice() for _ in range(r.u32())]
        pvs = [r.felt() for _ in range(r.u32())]
        per_air.append(pv.AirProofData(
            air_id=air_id, log_degree=degree.bit_length() - 1,
            exposed_values_after_challenge=exposed, public_values=pvs))

    kind = r.byte()
    if kind != RAP_PHASE_SEQ_KIND_FRI_LOG_UP:
        raise CodecError(f"unknown RapPhaseSeqKind: {kind}")
    logup_pow = r.u32()
    if logup_pow == _U32_MAX:
        logup_pow = 0
    elif logup_pow >= _P:
        raise CodecError(f"non-canonical logup pow witness {logup_pow}")

    if r.pos != len(data):
        raise CodecError(f"{len(data) - r.pos} trailing bytes after proof")

    # reconstruct the AIR height permutation with the prover's rule
    # (prover.py: stable sort by decreasing log_degree)
    perm = sorted(range(len(per_air)),
                  key=lambda i: -per_air[i].log_degree)

    return pv.Proof(
        commitments=pv.Commitments(main_trace=main_trace,
                                   after_challenge=after,
                                   quotient=quotient_c),
        opening=pv.Opening(
            proof=fri_mod.FriProof(commit_phase_commits=cpc,
                                   query_proofs=qps,
                                   final_poly=final_poly,
                                   pow_witness=fri_pow),
            values=pv.OpeningValues(preprocessed=prep, main=main,
                                    after_challenge=after_vals,
                                    quotient=quotient_vals)),
        per_air=per_air, air_perm_by_height=perm,
        log_up_pow_witness=logup_pow)
