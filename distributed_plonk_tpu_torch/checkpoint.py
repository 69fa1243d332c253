"""Prover checkpoint/resume: round-boundary snapshots of an in-flight prove
(a copy of the JAX package's checkpoint.py, minus its fsync option).

`prove(..., checkpoint=ProverCheckpoint(path))` persists, after each of
rounds 1-4, everything the remaining rounds need: the inter-round
polynomial handles, the Fiat-Shamir transcript sponge state, the blinder
RNG state, and the commitments/evaluations already produced. A new process
pointed at the same file resumes at the first unfinished round and
produces a proof BYTE-IDENTICAL to an uninterrupted run.

Design notes:
- One self-contained .npz file, written atomically (tmp + os.replace);
  each round overwrites the last, so at most one snapshot exists.
- Poly handles cross through the backend's `dump_h`/`load_h` as host
  numpy CANONICAL (16, L) uint32 16-bit limb arrays, the JAX package's
  layout, so a snapshot file is portable across backends AND packages: a
  prove started on the card can resume on the JAX package's host oracle
  and the reverse, both producing the same bytes.
- A workload fingerprint (hash of the verifying key and public input)
  binds the snapshot to its circuit+keys; resuming against anything else
  raises instead of silently producing an invalid proof.
- The transcript snapshot is the raw 200-byte STROBE/Keccak sponge state
  plus its three position counters (transcript.py `Strobe128`); the RNG
  snapshot is `random.Random.getstate()`: both restored exactly, so the
  challenge schedule and blinds continue bit-for-bit.
"""

import hashlib
import io
import json
import logging
import os
import zipfile

import numpy as np

from .backend.limbs import ints_to_limbs16, limbs16_to_ints
from .transcript import g1_to_bytes_compressed, fr_to_bytes

log = logging.getLogger("dpt.checkpoint")


def workload_fingerprint(vk, pub_input):
    """Hash binding a checkpoint to its circuit + proving keys."""
    h = hashlib.sha256()
    h.update(vk.domain_size.to_bytes(8, "little"))
    h.update(vk.num_inputs.to_bytes(8, "little"))
    for ki in vk.k:
        h.update(fr_to_bytes(ki))
    for comm in list(vk.selector_comms) + list(vk.sigma_comms):
        h.update(g1_to_bytes_compressed(comm))
    for x in pub_input:
        h.update(fr_to_bytes(x))
    return h.hexdigest()


def dump_handle(backend, h):
    """Poly handle -> canonical (16, L) uint32 limb array (host numpy).
    Backends may provide a fast `dump_h`; the fallback goes through the
    universal lower() int-list protocol."""
    fn = getattr(backend, "dump_h", None)
    if fn is not None:
        return fn(h)
    return ints_to_limbs16(backend.lower(h))


def load_handle(backend, arr):
    fn = getattr(backend, "load_h", None)
    if fn is not None:
        return fn(arr)
    return backend.lift(limbs16_to_ints(arr))


def _point_enc(p):
    """Affine point (x, y) host ints or None (identity) -> JSON value."""
    return None if p is None else [hex(p[0]), hex(p[1])]


def _point_dec(v):
    return None if v is None else (int(v[0], 16), int(v[1], 16))


def _transcript_state(transcript):
    s = transcript.t.strobe
    return {"state": bytes(s.state).hex(), "pos": s.pos,
            "pos_begin": s.pos_begin, "cur_flags": s.cur_flags}


def _restore_transcript(transcript, snap):
    s = transcript.t.strobe
    s.state = bytearray(bytes.fromhex(snap["state"]))
    s.pos = snap["pos"]
    s.pos_begin = snap["pos_begin"]
    s.cur_flags = snap["cur_flags"]


# -- snapshot <-> bytes codec -------------------------------------------------

def encode_snapshot(round_no, fingerprint, rng, transcript, arrays, meta):
    """One self-contained npz blob for a completed round.

    arrays: {name: host numpy array} (poly handle dumps);
    meta: JSON-able dict (commitments, evaluations) for this round.
    """
    rng_state = rng.getstate()
    manifest = {
        "round": round_no,
        "fingerprint": fingerprint,
        "transcript": _transcript_state(transcript),
        # Mersenne-Twister state: (version, 625 ints, gauss_next)
        "rng": [rng_state[0], list(rng_state[1]), rng_state[2]],
        "meta": meta,
    }
    buf = io.BytesIO()
    np.savez(buf, __manifest__=np.frombuffer(
        json.dumps(manifest).encode(), dtype=np.uint8), **arrays)
    return buf.getvalue()


def decode_snapshot(blob, fingerprint, origin="<blob>"):
    """Blob -> {round, arrays, meta, rng_state, transcript} state dict.

    Raises ValueError on a fingerprint mismatch (wrong circuit/keys: the
    caller must NOT silently rebuild over someone else's snapshot).
    Returns None on structural damage (truncated/bit-flipped npz, missing
    manifest): a corrupt snapshot is a missing snapshot, never a crash;
    the prove restarts from round 1 and, with a seeded RNG, still emits
    byte-identical proof bytes.
    """
    try:
        with np.load(io.BytesIO(blob)) as z:
            manifest = json.loads(bytes(z["__manifest__"]).decode())
            arrays = {k: z[k] for k in z.files if k != "__manifest__"}
        rng_state = (manifest["rng"][0], tuple(manifest["rng"][1]),
                     manifest["rng"][2])
        state = {
            "round": manifest["round"],
            "arrays": arrays,
            "meta": manifest["meta"],
            "rng_state": rng_state,
            "transcript": manifest["transcript"],
        }
        fp = manifest["fingerprint"]
    except (zipfile.BadZipFile, OSError, KeyError, json.JSONDecodeError,
            IndexError, TypeError, ValueError) as e:
        # ValueError here is np.load/json structural damage; the
        # fingerprint-mismatch ValueError is raised BELOW, outside this try
        log.warning("checkpoint %s undecodable (%s); treating as absent",
                    origin, e)
        return None
    if fp != fingerprint:
        raise ValueError(
            "checkpoint %s was written for a different circuit/keys "
            "(fingerprint %s != %s)" % (origin, fp, fingerprint))
    return state


class ProverCheckpoint:
    """Round-boundary checkpoint store backed by one .npz file.

    prove() drives it; user code only chooses the path:

        ck = ProverCheckpoint("run.ckpt.npz")
        proof = prove(rng, ckt, pk, backend, checkpoint=ck)

    If the process dies mid-prove, rerunning the same line resumes from
    the last completed round. `clear()` removes the file (prove() calls
    it on success so a finished run leaves nothing behind).
    """

    def __init__(self, path):
        self.path = path

    # -- write ---------------------------------------------------------------

    def save(self, round_no, fingerprint, rng, transcript, arrays, meta):
        """Persist a completed round atomically (tmp write + rename: a
        crash leaves the previous snapshot or the new one, never half)."""
        blob = encode_snapshot(round_no, fingerprint, rng, transcript,
                               arrays, meta)
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, self.path)

    # -- read ----------------------------------------------------------------

    def load(self, fingerprint):
        """Return {round, arrays, meta, rng_state, transcript_snap} for the
        stored snapshot, or None if no (readable) checkpoint exists: a
        damaged file is deleted so the rerun restarts cleanly. Raises
        ValueError on a fingerprint mismatch (wrong circuit/keys)."""
        try:
            with open(self.path, "rb") as f:
                blob = f.read()
        except OSError:
            return None
        state = decode_snapshot(blob, fingerprint, origin=self.path)
        if state is None:
            self.clear()
        return state

    def restore_into(self, state, rng, transcript):
        """Rewind rng + transcript to the snapshot point."""
        rng.setstate(state["rng_state"])
        _restore_transcript(transcript, state["transcript"])

    def has_snapshot(self):
        """Cheap existence probe (no decode): the batched and pipelined
        drivers route members that must RESUME to the sequential path,
        whose resume contract is the pinned one."""
        return os.path.exists(self.path)

    def clear(self):
        try:
            os.remove(self.path)
        except FileNotFoundError:
            pass

    def chaos_corrupt(self):
        """Fault injection: flip one byte mid-file. Returns True if there
        was a snapshot to corrupt. The next load() must detect the
        damage and restart the prove."""
        return _flip_middle_byte(self.path)


def _flip_middle_byte(path):
    """Chaos plane (runtime/faults.py corrupt_ckpt): XOR one byte at the
    midpoint of `path`, under whatever integrity layer guards it. True
    iff there were bytes to flip."""
    try:
        with open(path, "r+b") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            if not size:
                return False
            f.seek(size // 2)
            b = f.read(1)
            f.seek(size // 2)
            f.write(bytes([b[0] ^ 0xFF]))
        return True
    except OSError:
        return False


class StoreCheckpoint(ProverCheckpoint):
    """Round-boundary checkpoints as content-addressed store artifacts.

    Same format as the file backend (`encode_snapshot` npz bytes),
    persisted via `store.ArtifactStore` under `ckpt:<name>`, as the JAX
    package's StoreCheckpoint writes them, so a snapshot crosses packages
    through a shared store: SHA-256 integrity on every read (a
    bit-flipped snapshot is a detected miss, not a resumed-garbage
    prove), the one LRU byte budget, and the STORE_FETCH wire tag.
    """

    def __init__(self, store, name):
        super().__init__(path=None)
        self.store = store
        self.key = name if name.startswith("ckpt:") else f"ckpt:{name}"

    def save(self, round_no, fingerprint, rng, transcript, arrays, meta):
        blob = encode_snapshot(round_no, fingerprint, rng, transcript,
                               arrays, meta)
        self.store.put(self.key, blob,
                       meta={"kind": "prover_ckpt", "round": round_no,
                             "fingerprint": fingerprint})

    def load(self, fingerprint):
        blob = self.store.get(self.key)  # integrity-verified; corrupt=None
        if blob is None:
            return None
        state = decode_snapshot(blob, fingerprint, origin=self.key)
        if state is None:  # parse damage below the SHA's radar (stale fmt)
            self.clear()
        return state

    def has_snapshot(self):
        return self.store.get_entry(self.key) is not None

    def clear(self):
        self.store.delete(self.key)

    def chaos_corrupt(self):
        """Flip a byte in the backing object file (the store's SHA-256
        must catch it on the next get). Returns True if a snapshot
        existed: corruption is injected UNDER the integrity layer."""
        path = self.store.object_path(self.key)
        return path is not None and _flip_middle_byte(path)
