"""SimModel: the user-facing model API (reference parity: ``htf/simmodel.py``).

A ``SimModel`` subclass implements ``compute(nlist, positions, box, training)``
(taking 1-3 of the tensor args, optionally plus ``training``) and returns one
or more outputs; the first is interpreted as forces when ``output_forces``,
the second as virial when ``virial=True``. The tensor conventions match the
reference exactly (``simmodel.py:87-121``):

- ``nlist``: ``[N, NN, 4]`` -- minimum-image displacement to each neighbor
  plus neighbor type; all-zero rows pad short lists.
- ``positions``: ``[N, 4]`` -- xyz + type.
- ``box``: ``[3, 3]`` -- low, high, tilt rows.

Differences from the reference:

- No ``tf.function``/input-signature machinery: the model is a plain callable
  over ``jnp`` arrays; :class:`..md.simulation.Simulation` jit-compiles the
  full MD step (neighbor build + model + integrator) into one XLA program.
- ``compute_inputs``/``compute_outputs``/pointer plumbing do not exist: in a
  single-engine design the model's inputs are function arguments
  (see SURVEY.md section 2.2).
"""

import jax
import jax.numpy as jnp
import numpy as np

from .module import Layer, get_state, set_state
from ..ops import forces as _forces_mod
from ..ops.forces import ForceCapture

__all__ = ["SimModel", "MolSimModel"]


def _sniff_compute(fn, max_args, name):
    """Reference-parity arity sniffing (``simmodel.py:51-68``): how many of
    the positional tensor args does the user's compute take, and does it end
    with a ``training`` flag?"""
    try:
        code = fn.__code__
    except AttributeError:
        raise AttributeError(
            f"{name} child class must implement {fn} method")
    arg_count = code.co_argcount - 1  # drop self
    pass_training = (arg_count >= 1 and
                     code.co_varnames[arg_count] == "training")
    if pass_training:
        arg_count -= 1
    if arg_count > max_args:
        raise ValueError(
            f"compute takes at most {max_args} tensor arguments, got "
            f"{arg_count}")
    return arg_count, pass_training


class SimModel(Layer):
    """Base model for per-particle computation inside the MD step.

    :param nneighbor_cutoff: max number of neighbors NN (can be 0).
    :param output_forces: True if the model computes forces for the
        simulation (first output).
    :param virial: True if the model's second output is the virial.
    :param check_nlist: raise if the neighbor list overflows.
    :param dtype: floating point dtype of the model.

    Any extra ``kwargs`` are passed to :meth:`setup`.
    """

    def __init__(self, nneighbor_cutoff, output_forces=True, virial=False,
                 check_nlist=False, dtype=jnp.float32, name="htf-model",
                 **kwargs):
        super().__init__(name=name, dtype=dtype)
        self.nneighbor_cutoff = int(nneighbor_cutoff)
        self.output_forces = output_forces
        self.virial = virial
        self.check_nlist = check_nlist
        self._map_nlist = False
        self._map_fxn = None
        self._map_i = None
        # bumped by retrace_compute() so cached jitted closures invalidate
        self._trace_version = 0

        if SimModel.compute == type(self).compute and \
                not isinstance(self, MolSimModel):
            raise AttributeError(
                "You must implement compute method in subclass")

        self._arg_count, self._pass_training = _sniff_compute(
            self.compute, 3, "SimModel")

        # overflow flag surfaced when check_nlist and running under jit
        self.nlist_overflow = self.add_weight(
            (), trainable=False, dtype=jnp.bool_, name="nlist-overflow")
        self.batch_steps = self.add_weight(
            (), trainable=False, dtype=jnp.int32, name="htf-batch-steps")

        # training configuration (set by compile())
        self._optimizer = None
        self._loss = None
        self._opt_state = None
        self._jit_cache = {}

        # stash setup kwargs so get_config round-trips models whose layers
        # are created in setup() (the reference relies on Keras SavedModel
        # graph tracing for this; we serialize config + weights instead)
        self._setup_kwargs = dict(kwargs)
        self.setup(**kwargs)

    # ------------------------------------------------------------------
    def get_config(self):
        config = {
            "nneighbor_cutoff": self.nneighbor_cutoff,
            "output_forces": self.output_forces,
            "virial": self.virial,
            "check_nlist": self.check_nlist,
            "name": self.name,
            "dtype": str(np.dtype(self.dtype)),
        }
        config.update(self._setup_kwargs)
        return config

    @classmethod
    def from_config(cls, config):
        config = dict(config)
        if "dtype" in config:
            config["dtype"] = jnp.dtype(config["dtype"])
        return cls(**config)

    # ------------------------------------------------------------------
    def compute(self, nlist, positions, box, training=True):
        """The main computation; must be implemented by the subclass.

        May take fewer args (e.g. ``(nlist, positions)``) and an optional
        trailing ``training`` flag. Return one or more arrays; the first is
        forces (if ``output_forces``), the second virial (if ``virial``).
        Use :func:`..ops.forces.compute_nlist_forces` or
        :func:`..ops.forces.compute_positions_forces` to derive forces from
        an energy.
        """
        raise AttributeError("You must implement compute in your subclass")

    def setup(self, **kwargs):
        """Optional hook run at construction with leftover ctor kwargs."""
        pass

    def retrace_compute(self):
        """Invalidate compiled step functions that captured Python-level
        attributes of this model (reference parity: ``simmodel.py:147-163``).
        Call after mutating plain-Python state used inside ``compute``."""
        self._trace_version += 1
        self._jit_cache.clear()

    # ------------------------------------------------------------------
    def _check_nlist(self, nlist):
        """Reference-parity overflow check (``simmodel.py:216-224``)."""
        from ..ops.direct import NlistPlanes
        x = nlist.dx if isinstance(nlist, NlistPlanes) else nlist[:, :, 0]
        count = jnp.max(jnp.sum((x > 0).astype(jnp.int32), axis=1))
        full = count >= self.nneighbor_cutoff
        if isinstance(full, jax.core.Tracer):
            # under jit: fold into a flag the driver raises on
            self.nlist_overflow.assign(
                jnp.logical_or(self.nlist_overflow.value, full))
        elif bool(full):
            raise ValueError("Neighbor list is full!")

    def _prepare_args(self, inputs, training):
        from ..ops.direct import NlistPlanes
        inputs = list(inputs)
        args = [a if isinstance(a, NlistPlanes)
                else jnp.asarray(a, dtype=self.dtype)
                for a in inputs[: self._arg_count]]
        if self._arg_count >= 1 and not isinstance(args[0], NlistPlanes) \
                and args[0].ndim == 2:
            # flat [N*NN, 4] nlist -> [N, NN, 4]
            args[0] = args[0].reshape(-1, max(1, self.nneighbor_cutoff), 4)
        if self._arg_count >= 3:
            # box-skew guard mirrors simmodel.py:195 (eager only; under jit
            # the Simulation driver validates the box at attach time)
            skew = jnp.sum(jnp.abs(args[2][2]))
            if not isinstance(skew, jax.core.Tracer) and float(skew) >= 1e-4:
                raise ValueError("box is skewed")
        if self.check_nlist and self._arg_count >= 1:
            self._check_nlist(args[0])
        if self._pass_training:
            args.append(training)
        return args

    def __call__(self, inputs, training=False):
        """Run the model on ``inputs = [nlist, positions, box, ...]``.

        Returns a tuple of outputs (reference parity: ``simmodel.py:132-145``).
        """
        if isinstance(inputs, (jnp.ndarray, np.ndarray)):
            inputs = [inputs]
        args = self._prepare_args(inputs, training)
        # id-keyed snapshots tolerate variables created lazily mid-call
        # (Dense/MeanTensor build on first use)
        def snapshot():
            return {id(v): v.value for v in self.variables}

        def restore(snap):
            for v in self.variables:
                if id(v) in snap:
                    v.value = snap[id(v)]

        ctx = ForceCapture(
            self.compute, args,
            nlist_index=0 if self._arg_count >= 1 else None,
            positions_index=1 if self._arg_count >= 2 else None,
            snapshot=snapshot,
            restore=restore,
        )
        with ctx:
            out = self.compute(*args)
        if not isinstance(out, (tuple, list)):
            out = (out,)
        return tuple(out)

    # ------------------------------------------------------------------
    # CG mapped-nlist support (reference: simmodel.py:257-287)
    # ------------------------------------------------------------------
    def mapped_nlist(self, nlist):
        """Split nlist into (all-atom, mapped) parts after
        ``tfcompute.enable_mapped_nlist``. Works for the packed
        ``[N, NN, 4]`` form and the wide-planes
        :class:`..ops.direct.NlistPlanes` (row-sliced per component)."""
        if not self._map_nlist:
            raise ValueError(
                "You must call tfcompute.enable_mapped_nlist before using "
                "mapped_nlist")
        from ..ops.direct import NlistPlanes
        if isinstance(nlist, NlistPlanes):
            aa = NlistPlanes(*(c[: self._map_i] for c in nlist))
            mapped = NlistPlanes(*(c[self._map_i:] for c in nlist))
        else:
            aa, mapped = nlist[: self._map_i], nlist[self._map_i:]
        _forces_mod_register(aa, "nlist", 0, self._map_i)
        _forces_mod_register(mapped, "nlist", self._map_i, nlist.shape[0])
        return aa, mapped

    def mapped_positions(self, positions):
        """Split positions into (all-atom, mapped) parts after
        ``tfcompute.enable_mapped_nlist``."""
        if not self._map_nlist:
            raise ValueError(
                "You must call tfcompute.enable_mapped_nlist before using "
                "mapped_nlist")
        aa, mapped = positions[: self._map_i], positions[self._map_i:]
        _forces_mod_register(aa, "positions", 0, self._map_i)
        _forces_mod_register(mapped, "positions", self._map_i,
                             positions.shape[0])
        return aa, mapped

    # ------------------------------------------------------------------
    # Training surface (Keras-equivalent: compile / train_on_batch)
    # ------------------------------------------------------------------
    def compile(self, optimizer="adam", loss="mse", learning_rate=1e-3):
        """Configure for training.

        :param optimizer: an ``optax`` gradient transformation, or one of
            ``'adam'``/``'sgd'``.
        :param loss: loss spec: a callable ``f(y_true, y_pred)``, ``'mse'``/
            ``'mae'``, or a list aligned with model outputs where ``None``
            marks outputs not compared to labels (reference parity with
            Keras multi-output losses, ``tensorflowcompute.py:83-96``).
        """
        import optax
        if isinstance(optimizer, str):
            optimizer = {"adam": optax.adam(learning_rate),
                         "sgd": optax.sgd(learning_rate)}[optimizer.lower()]
        self._optimizer = optimizer
        self._loss = loss
        self._opt_state = None
        self._jit_cache.clear()

    @property
    def loss(self):
        if self._loss is None:
            raise AttributeError("SimModel has not been compiled")
        return self._loss if isinstance(self._loss, (list, tuple)) \
            else [self._loss]

    def _loss_fns(self):
        def resolve(spec):
            if spec is None:
                return None
            if callable(spec):
                return spec
            return {
                "mse": lambda yt, yp: jnp.mean((yt - yp) ** 2),
                "mae": lambda yt, yp: jnp.mean(jnp.abs(yt - yp)),
            }[spec.lower()]
        spec = self._loss
        if isinstance(spec, (list, tuple)):
            return [resolve(s) for s in spec]
        return [resolve(spec)]

    def compute_loss(self, outputs, y):
        """Total training loss: per-output losses + regularization."""
        fns = self._loss_fns()
        ys = y if isinstance(y, (list, tuple)) else [y]
        total = jnp.asarray(0.0, dtype=self.dtype)
        yi = 0
        for i, fn in enumerate(fns):
            if fn is None or i >= len(outputs):
                continue
            yt = jnp.asarray(ys[yi], dtype=self.dtype)
            yp = outputs[i]
            # labels may be [N,4] net forces incl. energy column while the
            # model emits [N,4]; compare the common leading columns
            if yt.ndim == 2 and yp.ndim == 2 and yt.shape[1] != yp.shape[1]:
                m = min(yt.shape[1], yp.shape[1])
                yt, yp = yt[:, :m], yp[:, :m]
            total = total + fn(yt, yp)
            yi = min(yi + 1, len(ys) - 1)
        for reg in self.losses:
            total = total + reg
        return total

    def ensure_built(self, x, training=False):
        """Materialize lazily-created variables (e.g. :class:`MeanTensor`)
        with one throwaway *abstract* call (``jax.eval_shape``), so the
        variable set is stable before the model is functionalized for
        jit/scan. Pre-existing variables are restored; new ones are reset
        to their initial values.

        The abstract call creates weights (initializers run eagerly, at
        their real shapes -- which may depend on the input widths) but
        performs zero device compute (an eager call would pay per-op
        dispatch)."""
        if getattr(self, "_built", False):
            return
        snap = {id(v): v.value for v in self.variables}
        jax.eval_shape(lambda xs: self.__call__(xs, training=training), x)
        for v in self.variables:
            v.value = snap.get(id(v), v.initial_value)
        self._built = True

    def train_on_batch(self, x, y, reset_metrics=False):
        """One optimizer step on a single batch (Keras-equivalent).

        :param x: model inputs ``[nlist, positions, box, ...]``.
        :param y: labels (typically reference forces ``[N, 3/4]``).
        :return: scalar loss value.
        """
        if self._optimizer is None:
            raise ValueError("SimModel has not been compiled")
        import optax

        self.ensure_built(x, training=True)
        variables = self.variables
        trainable_idx = [i for i, v in enumerate(variables) if v.trainable]
        values = get_state(self)
        if self._opt_state is None:
            self._opt_state = self._optimizer.init(
                [values[i] for i in trainable_idx])

        key = ("train", tuple(jnp.asarray(a).shape for a in x),
               jnp.asarray(y).shape, self._trace_version)
        if key not in self._jit_cache:
            def step(params, aux_values, opt_state, x, y):
                def loss_fn(params):
                    vals = list(aux_values)
                    for i, p in zip(trainable_idx, params):
                        vals[i] = p
                    old = get_state(self)
                    set_state(self, vals)
                    try:
                        out = self.__call__(x, training=True)
                        loss = self.compute_loss(out, y)
                        new_vals = get_state(self)
                    finally:
                        set_state(self, old)
                    return loss, new_vals
                (loss, new_vals), grads = jax.value_and_grad(
                    loss_fn, has_aux=True)(params)
                updates, opt_state = self._optimizer.update(
                    grads, opt_state, params)
                params = optax.apply_updates(params, updates)
                # apply Keras-style constraints post-update
                params = [
                    variables[i].constraint(p) if variables[i].constraint
                    else p
                    for i, p in zip(trainable_idx, params)]
                for j, i in enumerate(trainable_idx):
                    new_vals[i] = params[j]
                return loss, new_vals, opt_state
            self._jit_cache[key] = jax.jit(step)

        params = [values[i] for i in trainable_idx]
        loss, new_vals, self._opt_state = self._jit_cache[key](
            params, values, self._opt_state, [jnp.asarray(a) for a in x],
            jnp.asarray(y))
        set_state(self, new_vals)
        return loss


def _forces_mod_register(tensor, kind, start, stop):
    """Register a framework-produced slice with the active force capture."""
    ctx = _forces_mod._CAPTURE.get()
    if ctx is not None:
        ctx.register_slice(tensor, kind, start, stop)


def _make_reverse_indices(mol_indices):
    """Reverse map atom index -> (molecule, position) (reference parity:
    ``simmodel.py:714-733``). Expects 1-indexed, padded ``mol_indices``."""
    num_atoms = 0
    for m in mol_indices:
        num_atoms = max(num_atoms, max(m))
    rmi = [[] for _ in range(num_atoms)]
    for i in range(len(mol_indices)):
        for j in range(len(mol_indices[i])):
            index = mol_indices[i][j]
            if index > 0:
                rmi[index - 1] = [i, j]
    warned = False
    for r in rmi:
        if len(r) != 2 and not warned:
            warned = True
            print("Not all of your atoms are in a molecule\n")
            r.extend([-1, -1])
    return rmi


class MolSimModel(SimModel):
    """Molecule-batched :class:`SimModel` (reference: ``simmodel.py:342-489``).

    Subclasses implement ``mol_compute(nlist, positions, mol_nlist,
    mol_positions, box, training)`` (>= 3 tensor args). Per-particle arrays
    are gathered into per-molecule views ``mol_positions [M, MN, 4]`` and
    ``mol_nlist [M, MN, NN, 4]`` using 1-indexed padded ``mol_indices`` with
    a dummy row 0.

    .. note::
        Unlike the reference, no particle-sorter gymnastics are needed: this
        engine never reorders particles.
    """

    def __init__(self, MN, mol_indices, nneighbor_cutoff, output_forces=True,
                 virial=False, check_nlist=False, dtype=jnp.float32,
                 name="htf-mol-model", **kwargs):
        if MolSimModel.mol_compute == type(self).mol_compute:
            raise AttributeError(
                "You must implement mol_compute method in subclass of "
                "MolSimModel")
        self.MN = int(MN)
        # normalize to 1-indexed, zero-padded (reference simmodel.py:386-397)
        raw = [list(m) for m in mol_indices]
        for mi in raw:
            for i in range(len(mi)):
                mi[i] += 1
            if len(mi) > MN:
                raise ValueError("One of your molecule indices"
                                 " has more than MN indices."
                                 "Increase MN in your graph.")
            while len(mi) < MN:
                mi.append(0)
        self.mol_indices = raw
        self.rev_mol_indices = _make_reverse_indices(raw)

        self._mol_arg_count, self._mol_pass_training = _sniff_compute(
            self.mol_compute, 5, "MolSimModel")
        if self._mol_arg_count < 3:
            raise AttributeError(
                "You are creating a molecular batched model, but are only "
                "using per atom nlist/positions. Either use only SimModel or "
                "increase your argument count to mol_compute")

        super().__init__(nneighbor_cutoff, output_forces=output_forces,
                         virial=virial, check_nlist=check_nlist, dtype=dtype,
                         name=name, **kwargs)

    def get_config(self):
        config = super().get_config()
        config.update({"MN": self.MN, "mol_indices": self.mol_indices})
        return config

    def mol_compute(self, nlist, positions, mol_nlist, mol_positions, box,
                    training=True):
        """Molecule-batched computation; implemented by the subclass.
        See :meth:`SimModel.compute` for tensor conventions; ``mol_nlist``
        is ``[M, MN, NN, 4]`` and ``mol_positions`` is ``[M, MN, 4]``.
        Forces must still be computed from ``nlist`` (gradients flow through
        the gather back to it)."""
        raise AttributeError("You must implement mol_compute method")

    def compute(self, nlist, positions, box, training=True):
        mol_flat_idx = jnp.reshape(
            jnp.asarray(self.mol_indices, dtype=jnp.int32), (-1,))
        # dummy particle 0 absorbs padded (zero) indices
        ap = jnp.concatenate(
            [jnp.zeros((1, 4), dtype=positions.dtype), positions], axis=0)
        an = jnp.concatenate(
            [jnp.zeros((1, max(1, self.nneighbor_cutoff), 4),
                       dtype=nlist.dtype), nlist], axis=0)
        mol_positions = jnp.reshape(ap[mol_flat_idx], (-1, self.MN, 4))
        mol_nlist = jnp.reshape(
            an[mol_flat_idx],
            (-1, self.MN, max(1, self.nneighbor_cutoff), 4))
        inputs = [nlist, positions, mol_nlist, mol_positions, box]
        args = inputs[: self._mol_arg_count]
        if self._mol_pass_training:
            args.append(training)
        return self.mol_compute(*args)
