"""The verdicts a verifier batch must give: each named check of each slot,
worked out by the reference's plain verifier (verifier/stark.py), one proof
at a time, on its own parse of the proof's bytes with the slot's
corruptions planted in it."""

from __future__ import annotations

import copy

import numpy as np

from ..harness.work import verifier_perms
from . import config as config_mod
from .proof.parse import parse_plonk_with_poseidon_proof
from .verifier import stark

P = (1 << 31) - 1


def corrupted(proof, kind: str, where: tuple, delta: int):
    """A copy of a parsed proof with the value a corruption names moved by
    `delta` (harness/corrupt.py draws them), kept canonical."""
    proof = copy.deepcopy(proof)
    sp = proof.stark_proof
    if kind == "sampled_value":
        s, k = where
        for tree in sp.sampled_values:
            for col in tree:
                if s < len(col):
                    col[s, k] = (int(col[s, k]) + delta) % P
                    return proof
                s -= len(col)
        raise IndexError(f"no sample {where[0]}")
    if kind == "first_layer_witness":
        e, k = where
        w = sp.fri_proof.first_layer.fri_witness
        w[e, k] = (int(w[e, k]) + delta) % P
    elif kind == "inner_layer_witness":
        i, e, word = where
        dec = sp.fri_proof.inner_layers[i].decommitment
        hw = np.asarray(dec.hash_witness, np.uint32).reshape(-1, 8).copy()
        hw[e, word] = (int(hw[e, word]) + delta) % P
        dec.hash_witness = hw
    elif kind == "nonce":
        limbs = stark.split_nonce(int(sp.proof_of_work))
        limbs[where[0]] = (limbs[where[0]] + delta) % (1 << stark.NONCE_BITS[where[0]])
        sp.proof_of_work = stark.join_nonce(limbs)
    else:
        raise ValueError(f"unknown corruption {kind!r}")
    return proof


def proof_words(proof) -> int:
    """The M31 words of a proof: what a verifier has to read at least."""
    sp = proof.stark_proof
    fri = sp.fri_proof
    n = np.asarray(sp.commitments).size + 8 + 3
    n += sum(np.asarray(c).size for tree in sp.sampled_values for c in tree)
    n += sum(np.asarray(v).size for v in sp.queried_values)
    n += sum(np.asarray(d.hash_witness).size for d in sp.decommitments)
    for layer in [fri.first_layer] + list(fri.inner_layers):
        n += np.asarray(layer.fri_witness).size + np.asarray(layer.decommitment.hash_witness).size + 8
    return n + np.asarray(fri.last_layer_poly).size


class Reference:
    """The reference verifier of one configuration's proof."""

    def __init__(self, proof_bytes: bytes, config: dict):
        self.spec = config_mod.spec(config)
        self.inputs = config_mod.public_inputs(config)
        self.proof = parse_plonk_with_poseidon_proof(proof_bytes)
        self.names = stark.check_names(self.spec)

    def verdicts(self, rows: list) -> tuple:
        """(check names, (len(rows), n_checks) bool): row r is the proof with
        the corruptions rows[r] (a list of (kind, where, delta)) planted."""
        table = []
        for planted in rows:
            proof = self.proof
            for kind, where, delta in planted:
                proof = corrupted(proof, kind, where, delta)
            checks, _ = stark.verify_proof(self.spec, proof, self.inputs)
            table.append([checks[k] for k in self.names])
        return list(self.names), np.array(table, bool)

    def work(self) -> dict:
        """One proof's permutations and M31 words."""
        fs = stark.transcript(self.spec, self.proof)
        return {"perms_per_proof": verifier_perms(self.spec, fs.raw_queries, fs.permutations),
                "words_per_proof": proof_words(self.proof)}


def compare(names: list, calls: list, patterns: list, ref_names: list, table: np.ndarray, index: dict) -> dict:
    """Every call's verdicts against the reference's.

    calls: (pattern index, (n_checks, B) verdicts) a call; patterns: the
    corruptions (slot, kind, where, delta) of each pattern; table: the
    reference's verdicts, row 0 the clean proof and row index[(pattern,
    slot)] each corrupted slot it worked out.  A corrupted slot outside the
    index is not compared.  Returns the checks compared, the checks that
    differ, and the slots with a check that differs."""
    if list(names) != list(ref_names):
        raise ValueError(f"the checks {list(names)} are not the reference's {list(ref_names)}")
    compared = differing = wrong_slots = 0
    for p, got in calls:
        expected = np.repeat(table[0][:, None], got.shape[1], axis=1)
        keep = np.ones(got.shape[1], bool)
        for slot, *_ in patterns[p]:
            if (p, slot) in index:
                expected[:, slot] = table[index[(p, slot)]]
            else:
                keep[slot] = False
        off = got[:, keep] != expected[:, keep]
        compared += off.size
        differing += int(off.sum())
        wrong_slots += int(off.any(axis=0).sum())
    return {"compared": compared, "differing": differing, "wrong_slots": wrong_slots}
