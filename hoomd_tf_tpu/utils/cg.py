"""Coarse-graining utilities: molecule discovery, mapping operators,
PBC-aware centers of mass, exclusion lists.

Functional parity with the reference ``htf/utils.py`` CG stack, rewritten
host-side in vectorized numpy (e.g. molecule discovery is union-find over
the bond graph instead of a per-bond linear scan -- the reference notes its
own implementation "is a slow function", ``utils.py:236-284``).
"""

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["find_molecules", "find_molecules_from_topology",
           "matrix_mapping", "sparse_mapping", "center_of_mass",
           "gen_mapped_exclusion_list", "gen_bonds_group",
           "compute_ohe_bead_type_interactions"]


def _bonds_of(system):
    """Extract an ``[B, 2]`` int bond array from a system-like object:
    our :class:`..md.simulation.Simulation` (``.bonds``), a state dict, or
    any object with ``.bonds`` as index pairs."""
    bonds = getattr(system, "bonds", None)
    if bonds is None:
        raise ValueError("system has no bonds; set sim.bonds to an "
                         "[n_bonds, 2] index array")
    out = []
    for b in bonds:
        a = getattr(b, "a", None)
        if a is not None:
            out.append([int(a), int(b.b)])
        else:
            out.append([int(b[0]), int(b[1])])
    return np.asarray(out, dtype=np.int64).reshape(-1, 2)


def _n_particles_of(system):
    if hasattr(system, "state") and system.state is not None:
        return system.state.n_particles
    particles = getattr(system, "particles", None)
    if particles is not None:
        return len(particles)
    raise ValueError("cannot determine particle count of system")


def find_molecules(system):
    """Molecule index lists from a system's bond graph.

    Reference parity (``utils.py:236-284``): returns a list of per-molecule
    atom-index lists, each sorted ascending, the list of molecules sorted by
    smallest atom index. Implemented with union-find (near-linear) instead of
    repeated bond scans.

    :param system: a :class:`.Simulation` (or anything exposing ``bonds``
        and a particle count).
    """
    n = _n_particles_of(system)
    bonds = _bonds_of(system)
    parent = np.arange(n)

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for a, b in bonds:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra
    roots = np.array([find(i) for i in range(n)])
    groups = {}
    for i, r in enumerate(roots):
        groups.setdefault(r, []).append(i)
    mapping = sorted(groups.values(), key=lambda m: m[0])
    return [sorted(m) for m in mapping]


def find_molecules_from_topology(universe, atoms_in_molecule_list,
                                 selection="all"):
    """Molecule index lists from an MDAnalysis-style topology.

    Reference parity (``utils.py:287-337``): molecules are assumed to be
    laid out contiguously; each atom's residue name selects the molecule
    template whose length determines the grouping.

    :param universe: MDAnalysis Universe (or duck-typed equivalent with
        ``select_atoms`` and ``atoms.resnames``).
    :param atoms_in_molecule_list: per-residue-type list of atom-name lists.
    :param selection: atom selection string.
    """
    total = universe.select_atoms(selection).n_atoms
    resnames = np.asarray(universe.atoms.resnames)
    _, idx = np.unique(resnames, return_index=True)
    resname_list = resnames[np.sort(idx)].tolist()

    molecules = []
    current = []
    for i in range(total):
        mol_type = resname_list.index(resnames[i])
        mol_len = len(atoms_in_molecule_list[mol_type])
        if len(current) < mol_len:
            current.append(i)
        if len(current) == mol_len:
            molecules.append(current)
            current = []
    if molecules[-1][-1] != total - 1:
        raise Exception(
            "Mismatch found between the number of atoms in the system and "
            "the final index value. Check your atoms_in_molecule_list "
            "input.")
    return molecules


def matrix_mapping(molecule, beads_mappings, mass_weighted=True):
    """Molecule-level ``M x N`` mapping matrix from bead definitions.

    Reference parity (``utils.py:752-786``): rows are beads, columns atoms
    (in topology order); entries are atom masses normalized per bead.

    :param molecule: MDAnalysis atom selection (duck-typed: needs ``names``,
        ``masses``, ``n_atoms``, ``len``).
    :param beads_mappings: list of lists of atom-name strings per bead.
    :param mass_weighted: if False, returns ``(mass_weighted, binary)``.
    """
    mass_of = dict(zip(molecule.names, molecule.masses))
    m, n = len(beads_mappings), len(molecule)
    cg = np.zeros((m, n))
    col = 0
    for s, bead in enumerate(beads_mappings):
        for i, atom in enumerate(bead):
            matches = [v for k, v in mass_of.items() if atom in k]
            cg[s, col + i] = matches[0]
        col += np.count_nonzero(cg[s])
        cg[s] = cg[s] / np.sum(cg[s])
    assert col == molecule.n_atoms, (
        "Number of atoms in the beads mapping list does not match the "
        "number of atoms in topology.")
    if mass_weighted:
        return cg
    return cg, np.where(cg == 0, cg, 1)


def sparse_mapping(molecule_mapping, molecule_mapping_index, system=None):
    """System-level sparse ``B x N`` mapping operator.

    Reference parity (``utils.py:1040-1125``) but returns a JAX ``BCOO``
    sparse matrix (XLA-native) instead of a ``tf.SparseTensor``.

    :param molecule_mapping: list of per-molecule ``L x M`` numpy matrices
        (rows: beads, columns: atoms of that molecule).
    :param molecule_mapping_index: output of :func:`find_molecules`.
    :param system: optional system for mass weighting (a :class:`.Simulation`
        or an object with ``particles[i].mass``).
    """
    from jax.experimental import sparse as jsparse

    if not isinstance(molecule_mapping[0], np.ndarray):
        raise TypeError("molecule_mapping should be list of numpy arrays")
    if len(molecule_mapping_index) != len(molecule_mapping):
        raise ValueError(
            "Length of molecule_mapping_index and molecule_mapping must "
            "match")
    n = sum(len(m) for m in molecule_mapping_index)
    b = sum(m.shape[0] for m in molecule_mapping)

    def mass_lookup(idx):
        if system is None:
            return None
        if hasattr(system, "state") and system.state is not None:
            return float(np.asarray(system.state.masses)[idx])
        return float(system.particles[idx].mass)

    rows, cols, vals = [], [], []
    bead_base = 0
    for k, (mmi, mm) in enumerate(zip(molecule_mapping_index,
                                      molecule_mapping)):
        if len(mmi) != mm.shape[1]:
            raise ValueError(
                f"Mismatch in shapes of molecule_mapping_index and "
                f"molecule_mapping at index {k}. shape {len(mmi)} is "
                f"incompatible with {mm.shape}")
        local_rows, local_cols = np.nonzero(mm > 0)
        if system is not None:
            local_vals = np.array(
                [mass_lookup(mmi[j]) for j in local_cols])
            # normalize per bead by total mass
            bead_mass = np.zeros(mm.shape[0])
            np.add.at(bead_mass, local_rows, local_vals)
            assert np.all(bead_mass[np.unique(local_rows)] > 0)
            local_vals = local_vals / bead_mass[local_rows]
        else:
            local_vals = mm[local_rows, local_cols]
        rows.extend((local_rows + bead_base).tolist())
        cols.extend([mmi[j] for j in local_cols])
        vals.extend(local_vals.tolist())
        bead_base += mm.shape[0]
    assert bead_base == b, "Indices failed!"
    indices = np.stack([np.array(rows), np.array(cols)], axis=1)
    return jsparse.BCOO((jnp.asarray(np.array(vals, dtype=np.float32)),
                         jnp.asarray(indices)), shape=(b, n))


def center_of_mass(positions, mapping, box_size, name="center-of-mass"):
    """PBC-aware mapped positions via the circular mean.

    Reference parity (``utils.py:11-49``): maps ``[N, 3]`` positions through
    an ``[M, N]`` (sparse or dense) mapping using angle averaging so beads
    straddling the periodic boundary land correctly.

    :param positions: ``[N, 3+]`` positions (extra columns ignored).
    :param mapping: ``[M, N]`` mapping operator (BCOO or dense).
    :param box_size: ``[Lx, Ly, Lz]``.
    :return: ``[M, 3]`` mapped positions.
    """
    positions = jnp.asarray(positions)[:, :3]
    box_dim = jnp.asarray(box_size)
    theta = positions / box_dim * 2 * jnp.pi
    xi = jnp.cos(theta)
    zeta = jnp.sin(theta)
    # full f32 products: a TF32 matmul (the GPU default) would move
    # bead positions by ~1e-3 of the box
    with jax.default_matmul_precision("highest"):
        ximean = mapping @ xi
        zetamean = mapping @ zeta
    thetamean = jnp.arctan2(zetamean, ximean)
    return thetamean / (2 * jnp.pi) * box_dim


def gen_mapped_exclusion_list(universe, atoms_in_molecule, beads_mappings,
                              selection="all"):
    """Bead-bead exclusion matrix from atomic bonds via ``M A M^T``.

    Reference parity (``utils.py:357-396``).
    """
    n = len(universe.select_atoms(selection))
    bonds = np.asarray(
        universe.select_atoms(selection).bonds.to_indices())
    adj = np.zeros((n, n), dtype=bool)
    adj[bonds[:, 0], bonds[:, 1]] = True
    adj[bonds[:, 1], bonds[:, 0]] = True
    mm_mol = matrix_mapping(atoms_in_molecule, beads_mappings,
                            mass_weighted=False)[1]
    n_mol = n // mm_mol.shape[1]
    mm_sys = np.kron(np.eye(n_mol, dtype=int), mm_mol).astype(bool)
    excl = mm_sys @ adj @ mm_sys.T
    np.fill_diagonal(excl, False)
    return excl


def gen_bonds_group(mapped_exclusion_list):
    """Upper-triangular bond pairs from an exclusion matrix
    (reference parity: ``utils.py:399-412``)."""
    rows, cols = np.where(mapped_exclusion_list)
    keep = rows <= cols
    return np.stack([rows[keep], cols[keep]], axis=1)


def compute_ohe_bead_type_interactions(pos_btype, nlist_btype, n_btypes):
    """One-hot encoding of unordered bead-type pair interactions
    (reference parity: ``utils.py:52-72``).

    :param pos_btype: ``[N]`` int bead types of the centers.
    :param nlist_btype: ``[N, M]`` int bead types of the neighbors.
    :param n_btypes: number of unique bead types.
    :return: ``[N, M, I]`` one-hot with ``I = n_btypes*(n_btypes+1)/2``.
    """
    pos_btype = jnp.asarray(pos_btype)
    nlist_btype = jnp.asarray(nlist_btype)
    lo = jnp.minimum(pos_btype[..., None], nlist_btype)
    hi = jnp.maximum(pos_btype[..., None], nlist_btype)
    idx = lo * (2 * n_btypes - lo + 1) // 2 + hi - lo
    total = n_btypes * (n_btypes - 1) // 2 + n_btypes
    return jnp.eye(total, dtype=jnp.float32)[idx]
