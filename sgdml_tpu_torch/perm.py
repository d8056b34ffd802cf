"""Permutation-symmetry discovery (the "s" in sGDML) — host-side.

Finds the physical symmetry group of a molecule from trajectory data in
three stages (behavioral parity with reference sgdml/utils/perm.py:53-412):

1. **Bipartite matching**: for every geometry pair, match atoms by the
   overlap of adjacency-matrix eigenvectors (Hungarian algorithm) with a
   same-species penalty; keep matches that lower the adjacency distance.
2. **Permutation synchronization**: restrict to the minimum spanning tree
   of match costs to remove inconsistent matches.
3. **Transitive closure** to a group (capped at 100 elements), with a
   "salvage largest consistent subgroup" fallback when closure diverges.

This stage is run-once, tiny and irregular — exactly the kind of work that
belongs on the host CPU. Its output (the permutation table) becomes a
constant index table of the kernel assembly and of the prediction tables,
which is why nothing here needs to be device code. Unlike the reference
there are no forked worker pools or shared RawArrays: the pairwise cost
computation is vectorized with BLAS-backed einsums; only the Hungarian
solve remains a per-pair scipy call.

Plain numpy and scipy, kept identical to ``sgdml_tpu.perm`` so that both
packages find the same group on the same geometries.
"""

from __future__ import annotations

import logging

import numpy as np
import scipy.optimize
import scipy.sparse
from scipy.sparse.csgraph import minimum_spanning_tree

log = logging.getLogger(__name__)

MAX_PERMS = 100


def inv_perm(perm: np.ndarray) -> np.ndarray:
    """Inverse permutation (reference: sgdml/utils/perm.py:1035)."""
    inv = np.empty_like(np.asarray(perm))
    inv[perm] = np.arange(len(perm))
    return inv


def _adjacency_eigenvectors(R: np.ndarray, lat_and_inv=None):
    """Per-geometry pairwise-distance matrices and their sorted
    eigenvectors (descending eigenvalue order)."""
    diff = R[:, :, None, :] - R[:, None, :, :]
    if lat_and_inv is not None:
        lat, lat_inv = lat_and_inv
        c = np.einsum('ij,bnmj->bnmi', lat_inv, diff)
        diff = diff - np.einsum('ij,bnmj->bnmi', lat, np.round(c))
    adj = np.linalg.norm(diff, axis=-1)
    w, v = np.linalg.eigh(adj)  # symmetric: eigh (ascending order)
    v = v[:, :, ::-1]  # descending eigenvalue order
    return adj, np.abs(v)


def bipartite_match(R, z, lat_and_inv=None, max_processes=None, callback=None):
    """Pairwise atom matching across all geometry pairs.

    The ``n_train * (n_train - 1) / 2`` Hungarian solves fan out over a
    thread pool (scipy's ``linear_sum_assignment`` and the BLAS score
    math release the GIL), the host-side analog of the reference's
    forked worker pool (sgdml/utils/perm.py:202-213); the cost tensors
    and before-scores are computed vectorized per row.

    Returns
    -------
    match_perms_all: dict ``(i, j) -> perm`` for non-identity improving
        matches.
    match_cost: dense symmetric cost matrix (inf diagonal) used for MST
        synchronization.
    """
    import os
    from concurrent.futures import ThreadPoolExecutor

    R = np.asarray(R)
    z = np.asarray(z)
    n_train, n_atoms = R.shape[:2]

    same_z_cost = ((z[:, None] - z[None, :]) != 0).astype(np.float64)

    adj, v = _adjacency_eigenvectors(R, lat_and_inv)

    match_cost = np.zeros((n_train, n_train))
    match_perms_all = {}

    n_workers = max(1, int(max_processes or os.cpu_count() or 1))

    def match_pair(args):
        """One Hungarian solve + its adjacency score (GIL released in
        scipy/BLAS); returns (perm, score)."""
        cost, adj_i, adj_j = args
        _, perm = scipy.optimize.linear_sum_assignment(cost)
        score = np.linalg.norm(adj_i[perm][:, perm] - adj_j)
        return perm, score

    with ThreadPoolExecutor(max_workers=n_workers) as pool:
        pool_map = pool.map if n_workers > 1 else map
        for i in range(n_train):
            # Cost tensors against all later geometries in one einsum.
            cost_all = -np.einsum('nk,jmk->jnm', v[i], v[i + 1 :])
            scale = np.max(np.abs(cost_all), axis=(1, 2))
            cost_all += same_z_cost[None] * scale[:, None, None]
            scores_before = np.linalg.norm(
                adj[i][None] - adj[i + 1 :], axis=(1, 2)
            )
            results = pool_map(
                match_pair,
                ((cost_all[oj], adj[i], adj[i + 1 + oj])
                 for oj in range(n_train - i - 1)),
            )
            for oj, (perm, score) in enumerate(results):
                j = i + 1 + oj
                score_before = scores_before[oj]
                match_cost[i, j] = min(score, score_before)
                if score < score_before and not np.isclose(
                    score_before, score
                ):
                    match_perms_all[(i, j)] = perm
            if callback is not None:
                callback(i + 1, n_train)

    match_cost = match_cost + match_cost.T
    match_cost[np.diag_indices_from(match_cost)] = np.inf
    return match_perms_all, scipy.sparse.csr_matrix(match_cost)


def sync_perm_mat(match_perms_all, match_cost, n_atoms):
    """Keep only matches on the minimum spanning tree of pair costs
    (permutation synchronization; reference perm.py:238-259)."""
    tree = minimum_spanning_tree(match_cost, overwrite=True)
    perms = np.arange(n_atoms, dtype=int)[None, :]
    rows, cols = tree.nonzero()
    for edge in zip(rows, cols):
        perm = match_perms_all.get(edge)
        if perm is not None:
            perms = np.vstack((perms, perm))
    return np.unique(perms, axis=0)


def to_cycles(perm) -> list:
    """Disjoint-cycle decomposition of a permutation."""
    remaining = {i: p for i, p in enumerate(perm)}
    cycles = []
    while remaining:
        start = next(iter(remaining))
        cycle = []
        cur = start
        while cur in remaining:
            nxt = remaining.pop(cur)
            cycle.append(nxt)
            cur = nxt
        cycles.append(cycle)
    return cycles


def salvage_subgroup(perms: np.ndarray) -> np.ndarray:
    """Drop permutations whose cycles overlap with larger cycles elsewhere —
    used when transitive closure diverges (reference perm.py:289-341)."""
    n_perms = perms.shape[0]
    all_long = []
    for i in range(n_perms):
        all_long += [cy for cy in to_cycles(list(perms[i])) if len(cy) > 1]

    def intersects_larger(cy):
        return any(
            len(cy) < len(other) and not set(cy).isdisjoint(other)
            for other in all_long
        )

    keep = []
    for i in range(n_perms):
        long_cycles = [cy for cy in to_cycles(list(perms[i])) if len(cy) > 1]
        if not any(intersects_larger(cy) for cy in long_cycles):
            keep.append(i)
    return perms[keep]


def complete_sym_group(perms: np.ndarray, n_perms_max: int = MAX_PERMS):
    """Transitive closure under composition; None if it exceeds the cap
    (reference perm.py:344-381)."""
    perms = np.asarray(perms)
    added = True
    while added:
        added = False
        n = perms.shape[0]
        for i in range(n):
            for j in range(n):
                new = perms[i, perms[j]]
                if not (new == perms).all(axis=1).any():
                    added = True
                    perms = np.vstack((perms, new))
                    if n_perms_max is not None and perms.shape[0] == n_perms_max:
                        log.warning('Transitive closure of permutations failed.')
                        return None
    return perms


def find_perms(R, z, lat_and_inv=None, callback=None, max_processes=None):
    """Discover the molecule's permutation group from geometries ``R``.

    Returns a ``(P, N)`` integer array including the identity.
    """
    R = np.asarray(R)
    if R.ndim == 2:
        R = R.reshape(R.shape[0], -1, 3)
    n_atoms = R.shape[1]

    match_perms_all, match_cost = bipartite_match(
        R, z, lat_and_inv, max_processes, callback=callback
    )
    match_perms = sync_perm_mat(match_perms_all, match_cost, n_atoms)

    sym_group_perms = complete_sym_group(match_perms)
    if sym_group_perms is None:
        log.info('Closure disaster recovery: salvaging largest subgroup.')
        sym_group_perms = complete_sym_group(salvage_subgroup(match_perms))
        if sym_group_perms is None:
            sym_group_perms = np.arange(n_atoms)[None, :]

    log.info('Found %d symmetries.', sym_group_perms.shape[0])
    return sym_group_perms


# ---------------------------------------------------------------------------
# Experimental: fragment-based and alignment-based discovery
# (the reference ships these gated off — USE_FRAG_PERMS/USE_EXTRA_PERMS are
# False in sgdml/train.py:589,605; provided here for parity, same status)
# ---------------------------------------------------------------------------


def find_frags(r: np.ndarray, z: np.ndarray, cutoff: float = 1.9):
    """Partition atoms into molecular fragments by bond-distance cutoff
    (connected components; reference: sgdml/utils/perm.py:527).

    Returns a list of index arrays, one per fragment.
    """
    from scipy.sparse.csgraph import connected_components

    r = np.asarray(r).reshape(-1, 3)
    dist = np.linalg.norm(r[:, None] - r[None, :], axis=-1)
    adj = (dist < cutoff) & ~np.eye(len(r), dtype=bool)
    n_comp, labels = connected_components(
        scipy.sparse.csr_matrix(adj), directed=False
    )
    return [np.where(labels == i)[0] for i in range(n_comp)]


def _kabsch_rotation(p: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Optimal rotation aligning centered point sets p -> q (Kabsch/SVD;
    reference: sgdml/utils/perm.py:790)."""
    h = p.T @ q
    u, _, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    corr = np.diag([1.0, 1.0, d])
    return vt.T @ corr @ u.T


def find_perms_via_alignment(r_a, r_b, z, max_cost: float = 1.0):
    """Match atoms of two geometries after optimal rigid alignment
    (Kabsch + Hungarian with species constraint). Returns a permutation
    ``perm`` with ``r_a[perm] ~ aligned r_b``, or None if the match is
    poor (cost above ``max_cost`` per atom)."""
    r_a = np.asarray(r_a).reshape(-1, 3)
    r_b = np.asarray(r_b).reshape(-1, 3)
    z = np.asarray(z)

    ca, cb = r_a - r_a.mean(0), r_b - r_b.mean(0)
    rot = _kabsch_rotation(cb, ca)
    cb = cb @ rot.T

    cost = np.linalg.norm(ca[None, :, :] - cb[:, None, :], axis=-1)
    cost = cost + (z[None, :] != z[:, None]) * (10.0 + cost.max())
    rows, perm = scipy.optimize.linear_sum_assignment(cost)
    if cost[rows, perm].mean() > max_cost:
        return None
    return perm


def find_frag_perms(R, z, lat_and_inv=None, cutoff: float = 1.9,
                    max_processes=None):
    """Permutations that exchange identical molecular fragments
    (experimental; reference: sgdml/utils/perm.py:564, gated off there).

    For each geometry, fragments with identical species multisets are
    aligned pairwise; good alignments yield atom permutations that swap
    the two fragments while fixing all others.
    """
    R = np.asarray(R)
    if R.ndim == 2:
        R = R.reshape(R.shape[0], -1, 3)
    z = np.asarray(z)
    n_atoms = R.shape[1]

    r0 = R[0]
    frags = find_frags(r0, z, cutoff=cutoff)
    perms = {tuple(np.arange(n_atoms))}

    for i in range(len(frags)):
        for j in range(i + 1, len(frags)):
            fi, fj = frags[i], frags[j]
            if len(fi) != len(fj):
                continue
            if sorted(z[fi]) != sorted(z[fj]):
                continue
            match = find_perms_via_alignment(r0[fi], r0[fj], z[fi])
            if match is None:
                continue
            # Build the atom permutation swapping fragments i and j.
            perm = np.arange(n_atoms)
            # r0[fi][match] aligns to r0[fj]: atom fj[k] maps to fi[match[k]].
            perm[fj] = fi[match]
            match_back = find_perms_via_alignment(r0[fj], r0[fi], z[fj])
            if match_back is None:
                continue
            perm[fi] = fj[match_back]
            if np.array_equal(np.sort(perm), np.arange(n_atoms)):
                perms.add(tuple(perm))

    out = np.array(sorted(perms))
    group = complete_sym_group(out)
    return out if group is None else group


def find_perms_in_frag(R, z, frag_idxs, lat_and_inv=None, max_processes=None):
    """Symmetry search restricted to one molecular fragment: run the full
    permutation discovery on the sub-system and embed the result as
    whole-molecule permutations that fix every other atom
    (reference: sgdml/utils/perm.py:774-788).
    """
    R = np.asarray(R)
    if R.ndim == 2:
        R = R.reshape(R.shape[0], -1, 3)
    n_atoms = R.shape[1]
    frag_idxs = np.asarray(frag_idxs)

    frag_perms = find_perms(
        R[:, frag_idxs, :], np.asarray(z)[frag_idxs], lat_and_inv=lat_and_inv,
        max_processes=max_processes,
    )

    perms = np.tile(np.arange(n_atoms), (frag_perms.shape[0], 1))
    perms[:, frag_idxs] = frag_idxs[frag_perms]
    return perms


def find_perms_via_reflection(r, z, frag_idxs=None, plane_3idxs=None,
                              lat_and_inv=None, max_processes=None):
    """Permutation induced by mirroring (a fragment of) the molecule
    through a plane, found by matching original to reflected positions
    (reference: sgdml/utils/perm.py:917-965 — the reference version also
    prints jmol visualization commands, omitted here).

    Parameters
    ----------
    r: ``(N, 3)`` geometry.
    z: ``(N,)`` species (used to forbid cross-species matches; the
        reference matches on distance alone).
    frag_idxs: atoms to reflect (default: all).
    plane_3idxs: three plane-defining entries — atom indices, or
        2-tuples of atom indices whose bond centers define the plane.
    """
    r = np.asarray(r, dtype=np.float64).reshape(-1, 3)
    z = np.asarray(z)
    n_atoms = r.shape[0]
    if frag_idxs is None:
        frag_idxs = np.arange(n_atoms)
    frag_idxs = np.asarray(frag_idxs)
    if plane_3idxs is None:
        raise ValueError('plane_3idxs (three atoms or bond-center tuples) '
                         'is required')

    def _point(entry):
        if isinstance(entry, tuple):
            return 0.5 * (r[entry[0]] + r[entry[1]])
        return r[entry]

    a, b, c = (_point(e) for e in plane_3idxs)
    ab = (b - a) / np.linalg.norm(b - a)
    ac = (c - a) / np.linalg.norm(c - a)
    normal = np.cross(ab, ac)
    norm = np.linalg.norm(normal)
    if norm < 1e-12:
        raise ValueError('plane-defining points are collinear')
    normal = (normal / norm)[:, None]
    reflection = np.eye(3) - 2.0 * (normal @ normal.T)

    # Reflect the fragment about the plane through point `a`.
    r_ref = r.copy()
    r_ref[frag_idxs] = (r[frag_idxs] - a) @ reflection.T + a

    cost = np.linalg.norm(r[:, None, :] - r_ref[None, :, :], axis=-1)
    cost = cost + (z[:, None] != z[None, :]) * (10.0 + cost.max())
    _, perm = scipy.optimize.linear_sum_assignment(cost)
    return perm
