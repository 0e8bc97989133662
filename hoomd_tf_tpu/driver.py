"""tfcompute: the attach-style driver, API-compatible with the reference
(``htf/tensorflowcompute.py``).

In the reference this class wires a Keras model into HOOMD through the C++
plugin; here it wires a :class:`.models.simmodel.SimModel` into a
:class:`.md.simulation.Simulation`. The attach-time knobs (``r_cut``,
``period``, ``batch_size``, ``train``, ``save_output_period``), the
``outputs`` capture, ``set_reference_forces``, ``enable_mapped_nlist`` and
the ``get_*_array`` accessors all keep the reference's semantics.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np

from .models.simmodel import MolSimModel
from .ops.box import box_size

__all__ = ["tfcompute", "NLIST_MODES"]

# neighbor-list strategies accepted by tfcompute.attach(nlist=...)
NLIST_MODES = ("auto", "n2", "cell", "direct", "cellwise")


class tfcompute:
    """Applies a :class:`.SimModel` to a :class:`.Simulation`.

    :param model: the model.
    """

    def __init__(self, model):
        self.model = model
        self.sim = None
        self.outputs = None
        self.map_enabled = False
        self._calls = 0
        self.reference_forces = []
        self.loss_history = []
        self.opt_state = None
        self.trainable_idx = None
        self._map_fxn = None
        self._model_forces = None
        self._model_virial = None

    # ------------------------------------------------------------------
    def attach(self, sim, nlist=None, r_cut=0, period=1, batch_size=None,
               train=False, save_output_period=None):
        """Attach the model to a simulation.

        :param sim: the :class:`.Simulation` (replaces the implicit global
            hoomd context of the reference).
        :param nlist: neighbor-list strategy: ``None``/``'auto'`` (cell list
            for large boxes, dense otherwise), ``'n2'`` (dense O(N^2)),
            ``'cell'`` or a :class:`..ops.cell_list.CellList` config,
            ``'direct'`` (wide candidate planes, no selection), or
            ``'cellwise'`` / a :class:`..ops.cellwise.Cellwise` config
            (slot-resident state; the pair fast path -- the model
            sees ``NlistPlanes`` rows in *cell-slot order*, re-permuted
            at each repack, with inert ghost rows; models that index
            specific particle rows or reduce raw positions over rows
            need a particle-order mode, see docs/running.md). In the
            reference this argument is the HOOMD nlist object; here the
            engine owns the build.
        :param r_cut: neighbor cutoff radius.
        :param period: run the model every ``period`` MD steps.
        :param batch_size: particle-batch size for memory capping (not
            compatible with molecule batching).
        :param train: train each model call with reference forces as labels
            (the ``hoomd2tf`` mode).
        :param save_output_period: capture extra model outputs every this
            many model calls into ``self.outputs``.
        """
        if sim is None or sim.state is None:
            raise RuntimeError("Must initialize the simulation first")
        from .ops.cell_list import CellList
        if not (nlist is None or isinstance(nlist, CellList) or
                nlist in NLIST_MODES):
            raise ValueError(
                f"nlist={nlist!r}: expected None, a CellList/Cellwise "
                f"config, or one of {NLIST_MODES}")
        self.sim = sim
        self.nlist_method = nlist
        # r_cut: scalar, or an [ntypes, ntypes] per-type-pair matrix with
        # negative entries meaning "never neighbors" (reference parity:
        # tensorflowcompute.py:284-305 rcut()). The scalar used for cell
        # planning is the matrix max; the per-pair filter applies in every
        # neighbor build.
        r_arr = np.asarray(r_cut, dtype=np.float64)
        if r_arr.ndim == 0:
            self.r_cut = float(r_arr)
            self.r_cut_matrix = None
        elif r_arr.ndim == 2 and r_arr.shape[0] == r_arr.shape[1]:
            self.r_cut_matrix = r_arr.astype(np.float32)
            pos_entries = r_arr[r_arr > 0]
            self.r_cut = float(pos_entries.max()) if pos_entries.size \
                else 0.0
        else:
            raise ValueError(
                f"r_cut must be a scalar or square [ntypes, ntypes] "
                f"matrix, got shape {r_arr.shape}")
        self.period = int(period)
        self.batch_size = 0 if batch_size is None else int(batch_size)
        self.train = bool(train)
        self.save_output_period = save_output_period
        self.nneighbor_cutoff = self.model.nneighbor_cutoff
        self.outputs = None
        self._calls = 0

        # output offset bookkeeping (reference tensorflowcompute.py:81-96)
        self.output_offset = 0
        if self.model.output_forces:
            self.output_offset = 1
        if self.model.virial:
            self.output_offset = 2
        if train:
            losses = self.model.loss  # raises if not compiled (parity)
            i = 0
            for i, l in enumerate(losses):
                if l is None:
                    break
            self.output_offset = i

        if isinstance(self.model, MolSimModel):
            if self.batch_size != 0:
                raise ValueError(
                    "Cannot batch by molecule and by batch_number")
        from .ops.cellwise import Cellwise
        planes_mode = (nlist in ("direct", "cellwise") or
                       isinstance(nlist, Cellwise))
        if planes_mode and (self.batch_size or
                            isinstance(self.model, MolSimModel)):
            raise ValueError(
                f"nlist={nlist!r} is incompatible with particle batching "
                "and molecule batching (it changes the nlist form the "
                "model sees). Mapped neighbor lists ARE supported: the "
                "model receives particle-order NlistPlanes")

        if self.nneighbor_cutoff > 0 and self.r_cut <= 0:
            raise ValueError("Must provide an r_cut if you have "
                             "nneighbor_cutoff > 0")

        if (self.map_enabled and self.r_cut_matrix is None and
                self.nneighbor_cutoff > 0):
            # mapped nlist: AA and CG bead types never neighbor each other
            # -- synthesize the reference's rcut() matrix (negative for
            # AA<->CG pairs, tensorflowcompute.py:284-305) so every build
            # path applies the exclusion uniformly
            ntypes = int(np.max(np.asarray(sim.state.types))) + 1
            k = self._map_typeid_start
            m = np.full((ntypes, ntypes), self.r_cut, dtype=np.float32)
            m[:k, k:] = -1.0
            m[k:, :k] = -1.0
            self.r_cut_matrix = m

        # The reference rejects any skew (simmodel.py:195 'box is
        # skewed'); this engine supports triclinic boxes up to HOOMD's
        # tilt convention (|tilt| <= 0.5, where the sequential
        # minimum-image wrap is exact) and only rejects beyond it.
        tilt_max = float(jnp.max(jnp.abs(sim.state.box[2])))
        if tilt_max > 0.5 + 1e-9:
            raise ValueError(
                f"box tilt factors must satisfy |tilt| <= 0.5 (HOOMD "
                f"convention); got max |tilt| = {tilt_max:.4f} -- "
                "lattice-reduce the box first")

        sim.tfc = self
        sim._scan_cache.clear()
        return self

    @property
    def optimizer(self):
        opt = self.model._optimizer
        if opt is None:
            raise ValueError("SimModel has not been compiled")
        return opt

    @property
    def config_key(self):
        return (self.r_cut,
                self.r_cut_matrix.tobytes()
                if self.r_cut_matrix is not None else None,
                self.nneighbor_cutoff, self.period,
                self.batch_size, self.train, self.save_output_period,
                self.map_enabled, self.model._trace_version,
                id(self.nlist_method) if self.nlist_method is not None
                else None,
                tuple(id(f) for f in self.reference_forces))

    # ------------------------------------------------------------------
    def set_reference_forces(self, *forces):
        """Choose which built-in forces are the training label (reference
        parity: ``tensorflowcompute.py:265-282``; default is all of them,
        the analog of HOOMD's net force)."""
        if not self.train and self.model.output_forces:
            raise ValueError("Only valid to set reference forces if mode "
                             "is hoomd2tf")
        for f in forces:
            if self.sim is not None and f not in self.sim.forces:
                raise ValueError("given force does not seem like a "
                                 "simulation force (add it with "
                                 "sim.add_force first)")
        self.reference_forces = list(forces)
        if self.sim is not None:
            self.sim._scan_cache.clear()

    # ------------------------------------------------------------------
    def enable_mapped_nlist(self, sim, mapping_fxn):
        """Append CG beads to the simulation so bead-bead neighbor lists are
        built by the engine (reference parity:
        ``tensorflowcompute.py:198-263``). Returns ``(aa_group, map_group)``
        index arrays. Call before :meth:`attach`."""
        state = sim.state
        if state is None:
            raise RuntimeError("Must initialize the simulation first")
        bs = box_size(state.box)
        cg_pos = np.asarray(mapping_fxn(
            state.positions4, [float(bs[0]), float(bs[1]), float(bs[2])]))
        m = cg_pos.shape[0]
        aan = state.n_particles
        map_typeid_start = int(np.max(np.asarray(state.types))) + 1
        dtype = state.positions.dtype

        new_types = (cg_pos[:, 3].astype(np.int32) + map_typeid_start)
        positions = jnp.concatenate(
            [state.positions, jnp.asarray(cg_pos[:, :3], dtype=dtype)],
            axis=0)
        types = jnp.concatenate(
            [state.types, jnp.asarray(new_types, dtype=jnp.int32)], axis=0)
        velocities = jnp.concatenate(
            [state.velocities, jnp.zeros((m, 3), dtype=dtype)], axis=0)
        masses = jnp.concatenate(
            [state.masses, jnp.ones(m, dtype=dtype)], axis=0)
        n = aan + m
        sim.state = dataclasses.replace(
            state, positions=positions, types=types, velocities=velocities,
            masses=masses,
            forces=jnp.zeros((n, 4), dtype=dtype),
            virial=jnp.zeros((n, 3, 3), dtype=dtype))
        sim._scan_cache.clear()

        self.map_enabled = True
        self._map_fxn = mapping_fxn
        self._map_typeid_start = map_typeid_start
        self.model._map_nlist = True
        self.model._map_fxn = mapping_fxn
        self.model._map_i = aan
        aa_group = np.arange(aan)
        map_group = np.arange(aan, n)
        return aa_group, map_group

    def apply_mapping(self, state):
        """Per-step CG mapped-position write-back (reference precompute,
        ``simmodel.py:289-339``): recompute bead positions from the current
        all-atom positions. Types are not overwritten."""
        aan = self.model._map_i
        bs = box_size(state.box)
        cg = self._map_fxn(state.positions4[:aan], bs)
        cg3 = jnp.asarray(cg)[:, :3].astype(state.positions.dtype)
        positions = jnp.concatenate([state.positions[:aan], cg3], axis=0)
        return dataclasses.replace(state, positions=positions)

    # ------------------------------------------------------------------
    # hooks used by Simulation.run
    # ------------------------------------------------------------------
    def persisted_model_forces(self, n, dtype):
        """Model forces/virial carried over from the previous run (the
        reference's force staging buffer persists between period-gated
        evaluations)."""
        if (self._model_forces is not None and
                self._model_forces.shape[0] == n):
            mvir = self._model_virial
            if mvir is None or mvir.shape[0] != n:
                mvir = jnp.zeros((n, 3, 3), dtype=dtype)
            return self._model_forces, mvir
        return (jnp.zeros((n, 4), dtype=dtype),
                jnp.zeros((n, 3, 3), dtype=dtype))

    def ensure_opt_state(self, values):
        variables = self.model.variables
        self.trainable_idx = [i for i, v in enumerate(variables)
                              if v.trainable]
        if self.opt_state is None:
            self.opt_state = self.optimizer.init(
                [values[i] for i in self.trainable_idx])
        return self.opt_state

    def collect_outputs(self, start_step, n, ys):
        """Host-side bookkeeping per scan block: saved outputs & loss
        history (reference parity: ``tensorflowcompute.py:313-370``).
        Called once per dispatched block, so host/device buffers stay
        bounded by ``Simulation.scan_block``."""
        losses, extras = ys
        if not self.train and not (self.save_output_period and extras):
            return
        steps = np.arange(start_step, start_step + n)
        eval_mask = steps % self.period == 0
        if self.train:
            self.loss_history.extend(
                np.asarray(losses)[eval_mask].tolist())
        call_numbers = self._calls + np.cumsum(eval_mask)
        self._calls += int(eval_mask.sum())
        if not self.save_output_period or not extras:
            return
        save_mask = eval_mask & (call_numbers % self.save_output_period == 0)
        captured = [np.asarray(e)[save_mask] for e in extras]
        if self.batch_size:
            # flatten the per-chunk axis into the capture axis, matching the
            # reference's per-batch output appends
            captured = [c.reshape((-1,) + c.shape[2:]) for c in captured]
        if not captured or captured[0].shape[0] == 0:
            return
        if self.outputs is None:
            self.outputs = captured
        else:
            self.outputs = [np.concatenate([o, c], axis=0)
                            for o, c in zip(self.outputs, captured)]

    def check_overflow(self):
        if self.model.check_nlist and bool(self.model.nlist_overflow.value):
            self.model.nlist_overflow.assign(False)
            raise ValueError("Neighbor list is full!")

    # ------------------------------------------------------------------
    # numpy accessors (reference parity: tensorflowcompute.py:372-392)
    # ------------------------------------------------------------------
    def get_positions_array(self):
        return np.asarray(self.sim.state.positions4)

    def get_nlist_array(self):
        from .ops.direct import NlistPlanes
        nl = self.sim._build_nlist(self.sim.state)
        if isinstance(nl, NlistPlanes):
            nl = nl.stack()
        return np.asarray(nl)

    def get_forces_array(self):
        """In tf2hoomd mode: the net forces. In hoomd2tf (train/observe)
        mode with reference forces selected: the staged label forces, like
        the reference's forces buffer (``TensorflowCompute.cc:177-187``)."""
        if self.train and self.reference_forces:
            state = self.sim.state
            nlist = self.sim._build_nlist(state)
            f, _ = self.sim._builtin_forces(state, nlist,
                                            subset=self.reference_forces)
            return np.asarray(f)
        return np.asarray(self.sim.state.forces)

    def get_virial_array(self):
        return np.asarray(self.sim.state.virial).reshape(-1, 9)
