"""Data-parallel training over a device mesh.

The particle dimension is sharded by the ENGINE: ``Simulation(mesh=...)``
(or :class:`.sharded_simulation.ShardedSimulation`) runs the one compiled
step SPMD with the slot-resident state partitioned along z-slabs -- the
replacement for the reference's MPI spatial decomposition
(SURVEY.md section 2.3). There is deliberately no second particle-sharded
force path in this package.

What lives here is the OTHER parallel axis from SURVEY.md section 2.3:
**data parallelism over frames/batches** for offline training
(force-matching over trajectory frames, reference examples 06/08,
``utils.py:627-749``). Frames are sharded over the mesh; every device
runs the model's standard packed-nlist route on its local frames; psum'd
gradients keep the replicated parameters identical.
"""

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..models.module import get_state, set_state

__all__ = ["data_parallel_grads", "sharded_train_step"]


def data_parallel_grads(grads, axis="d"):
    """psum gradients across the mesh (to call inside shard_map/pjit when
    sharding training batches over devices)."""
    return jax.tree_util.tree_map(
        lambda g: jax.lax.psum(g, axis), grads)


def sharded_train_step(model, optimizer, mesh, axis="d"):
    """A jittable force-matching training step with trajectory FRAMES
    sharded over the mesh.

    Each device evaluates the model's standard call (the same route
    every single-device path uses -- no bespoke sharded force engine) on
    its local frames, computes the MSE against the per-frame label
    forces, and the gradients are ``pmean``'d across devices before one
    replicated optax update -- the classic data-parallel recipe, applied
    to the reference's offline-training loop (example 08's
    ``train_on_batch`` over ``iter_from_trajectory`` frames).

    :param model: a built :class:`..models.simmodel.SimModel`.
    :param optimizer: an optax gradient transformation.
    :param mesh: the device mesh.
    :param axis: mesh axis name carrying the frame batch.
    :returns: ``step(params, aux_values, opt_state, nlist_b, pos4_b,
        box, labels_b) -> (loss, params, opt_state)`` where ``nlist_b``
        is ``[B, N, NN, 4]``, ``pos4_b`` ``[B, N, 4]``, ``labels_b``
        ``[B, N, >=3]`` with ``B`` divisible by the mesh size, ``box``
        replicated, ``params`` the trainable variable values and
        ``aux_values`` the full variable-value list.
    """
    import optax

    variables = model.variables
    trainable_idx = [i for i, v in enumerate(variables) if v.trainable]

    def step(params, aux_values, opt_state, nlist_b, pos4_b, box,
             labels_b):
        def shard_body(params, aux_values, nlist_s, pos4_s, box,
                       labels_s):
            def loss_fn(params):
                vals = list(aux_values)
                for i, p in zip(trainable_idx, params):
                    vals[i] = p

                def frame_loss(nl, p4, lab):
                    old = get_state(model)
                    set_state(model, vals)
                    try:
                        out = model([nl, p4, box], training=True)
                    finally:
                        set_state(model, old)
                    pred = out[0][:, :3]
                    return jnp.mean((pred - lab[:, :3]) ** 2)

                return jnp.mean(jax.vmap(frame_loss)(
                    nlist_s, pos4_s, labels_s))

            loss, grads = jax.value_and_grad(loss_fn)(params)
            loss = jax.lax.pmean(loss, axis)
            grads = jax.tree_util.tree_map(
                lambda g: jax.lax.pmean(g, axis), grads)
            return loss, grads

        loss, grads = jax.shard_map(
            shard_body, mesh=mesh,
            in_specs=(P(), P(), P(axis), P(axis), P(), P(axis)),
            out_specs=(P(), P()),
            check_vma=False)(tuple(params), tuple(aux_values),
                             nlist_b, pos4_b, box, labels_b)
        updates, opt_state = optimizer.update(list(grads), opt_state,
                                              list(params))
        params = optax.apply_updates(list(params), updates)
        return loss, params, opt_state

    return step
