"""SimModel behaviors: arity sniffing, force capture, stateful layers,
training, serialization, MolSimModel batching."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import hoomd_tf_tpu as htf
import zoo


def make_inputs(n=9, NN=8, seed=0, L=8.0, r_cut=4.0):
    rng = np.random.RandomState(seed)
    box_l = np.array([L, L, L], dtype=np.float32)
    pos = (rng.rand(n, 3) * box_l - box_l / 2).astype(np.float32)
    pos4 = np.concatenate([pos, np.zeros((n, 1), np.float32)], axis=1)
    nlist = htf.compute_nlist(jnp.asarray(pos4), r_cut, NN, box_l,
                              sorted=True, return_types=True)
    box = htf.box_from_lengths(box_l)
    return [nlist, jnp.asarray(pos4), box]


class TestConstruction:
    def test_must_implement_compute(self):
        with pytest.raises(AttributeError):
            htf.SimModel(4)

    def test_arity_sniffing(self):
        m1 = zoo.BenchmarkPotential(4)
        assert m1._arg_count == 1 and not m1._pass_training
        m2 = zoo.SimplePotential(4)
        assert m2._arg_count == 2
        m3 = zoo.LJModel(4)
        assert m3._arg_count == 3
        m4 = zoo.TrainModel(4, dim=3, top_neighs=2)
        assert m4._arg_count == 2 and m4._pass_training

    def test_setup_kwargs(self):
        m = zoo.NlistNN(4, dim=5, top_neighs=2)
        assert m.top_neighs == 2

    def test_single_output_wrapped(self):
        m = zoo.SimplePotential(8)
        out = m(make_inputs())
        assert isinstance(out, tuple) and len(out) == 1


class TestForceCapture:
    def test_lj_model_matches_callable_form(self):
        inputs = make_inputs()
        model = zoo.LJModel(8)
        forces = model(inputs)[0]

        def energy_fn(nl):
            rinv = htf.nlist_rinv(nl)
            inv_r6 = rinv ** 6
            return jnp.sum(4.0 / 2.0 * (inv_r6 ** 2 - inv_r6), axis=1)

        direct = htf.compute_nlist_forces(inputs[0], energy_fn)
        np.testing.assert_allclose(np.asarray(forces), np.asarray(direct),
                                   rtol=1e-5, atol=1e-6)

    def test_newton_third_law(self):
        inputs = make_inputs()
        model = zoo.LJModel(8)
        forces = np.asarray(model(inputs)[0])
        np.testing.assert_allclose(forces[:, :3].sum(axis=0),
                                   np.zeros(3), atol=1e-4)

    def test_positions_forces_capture(self):
        inputs = make_inputs()

        class PosModel(htf.SimModel):
            def compute(self, nlist, positions, box):
                energy = jnp.sum(positions[:, :3] ** 2)
                return htf.compute_positions_forces(positions, energy)

        model = PosModel(8)
        f = np.asarray(model(inputs)[0])
        np.testing.assert_allclose(
            f[:, :3], -2 * np.asarray(inputs[1])[:, :3], rtol=1e-5)

    def test_virial_model(self):
        inputs = make_inputs()
        model = zoo.LJVirialModel(8, virial=True)
        forces, virial = model(inputs)
        assert virial.shape == (9, 3, 3)
        # symmetric
        np.testing.assert_allclose(np.asarray(virial),
                                   np.swapaxes(np.asarray(virial), 1, 2),
                                   atol=1e-6)

    def test_works_under_jit(self):
        inputs = make_inputs()
        model = zoo.LJModel(8)
        eager = model(inputs)[0]

        @jax.jit
        def jitted(nlist, pos, box):
            return model([nlist, pos, box])[0]

        np.testing.assert_allclose(np.asarray(jitted(*inputs)),
                                   np.asarray(eager), rtol=1e-5, atol=1e-6)

    def test_metrics_update_once_per_call(self):
        """The capture replay must not double-count stateful updates."""
        inputs = make_inputs()
        model = zoo.LJRunningMeanModel(8)
        model(inputs)
        assert float(model.avg_energy.count.value) == 9.0
        model(inputs)
        assert float(model.avg_energy.count.value) == 18.0

    def test_grad_flows_to_params_through_capture(self):
        inputs = make_inputs()
        model = zoo.TrainableGraph(8)
        values = htf.models.get_state(model)
        variables = model.variables
        t_idx = [i for i, v in enumerate(variables) if v.trainable]

        def loss(params):
            vals = list(values)
            for i, p in zip(t_idx, params):
                vals[i] = p
            (out,), _ = htf.models.functional_call(
                model, vals, lambda: model(inputs))
            return jnp.sum(out[:, :3] ** 2)

        g = jax.grad(loss)([values[i] for i in t_idx])
        assert any(float(jnp.sum(jnp.abs(gi))) > 0 for gi in g)


class TestMixedForceCalls:
    def test_nlist_and_positions_forces_in_one_compute(self):
        """Both force kinds in one compute: the capture's call counter keeps
        the replays aligned."""
        inputs = make_inputs()

        class Mixed(htf.SimModel):
            def compute(self, nlist, positions, box):
                rinv = htf.nlist_rinv(nlist)
                f1 = htf.compute_nlist_forces(nlist, jnp.sum(rinv, axis=1))
                e2 = jnp.sum(positions[:, :3] ** 2)
                f2 = htf.compute_positions_forces(positions, e2)
                return f1[:, :3] + f2[:, :3]

        f = np.asarray(Mixed(8)(inputs)[0])
        fa = htf.compute_nlist_forces(
            inputs[0], lambda nl: jnp.sum(htf.nlist_rinv(nl), axis=1))
        fb = htf.compute_positions_forces(
            inputs[1], lambda p: jnp.sum(p[:, :3] ** 2))
        np.testing.assert_allclose(
            f, np.asarray(fa[:, :3] + fb[:, :3]), atol=1e-5)


class TestBfloat16:
    def test_model_runs_in_bf16(self):
        """dtype=bfloat16 works end to end (tensor-core-native
        precision); ~1e-2 force error vs f32 is expected."""
        inputs = make_inputs()
        m16 = zoo.LJModel(8, dtype=jnp.bfloat16)
        out = m16(inputs)[0]
        assert out.dtype == jnp.bfloat16
        f16 = np.asarray(out, dtype=np.float32)
        f32 = np.asarray(zoo.LJModel(8)(inputs)[0])
        assert np.all(np.isfinite(f16))
        scale = max(1.0, np.abs(f32).max())
        np.testing.assert_allclose(f16, f32, atol=0.05 * scale)


class TestTrainingFlag:
    def test_training_changes_output(self):
        inputs = make_inputs()
        model = zoo.TrainModel(8, dim=4, top_neighs=4)
        f_train = model(inputs, training=True)[0]
        f_infer = model(inputs, training=False)[0]
        # training doubles the energy -> forces double
        np.testing.assert_allclose(np.asarray(f_train[:, :3]),
                                   2 * np.asarray(f_infer[:, :3]),
                                   rtol=1e-4, atol=1e-6)


class TestTrainOnBatch:
    def test_weights_move_and_loss_decreases(self):
        inputs = make_inputs()
        model = zoo.TrainableGraph(8)
        model.compile(optimizer="adam", loss="mse", learning_rate=1e-2)
        labels = jnp.zeros((9, 4))
        w0 = model.get_weights()
        losses = [float(model.train_on_batch(inputs, labels))
                  for _ in range(20)]
        w1 = model.get_weights()
        moved = any(not np.allclose(a, b) for a, b in zip(w0, w1))
        assert moved
        assert losses[-1] < losses[0]

    def test_nn_model_trains(self):
        inputs = make_inputs()
        model = zoo.TrainModel(8, dim=4, top_neighs=4)
        model.compile(optimizer="adam", loss=["mse", None],
                      learning_rate=1e-3)
        target = np.zeros((9, 4), dtype=np.float32)
        l0 = float(model.train_on_batch(inputs, target))
        for _ in range(10):
            l1 = float(model.train_on_batch(inputs, target))
        assert np.isfinite(l0) and np.isfinite(l1)

    def test_uncompiled_raises(self):
        model = zoo.LJModel(8)
        with pytest.raises(ValueError):
            model.train_on_batch(make_inputs(), jnp.zeros((9, 4)))


class TestWCARegularizer:
    def test_sigma_pushed_up_by_regularizer(self):
        """The WCA negative-strength regularizer pushes sigma toward larger
        distances during training (reference layers.py:52-98 semantics)."""
        inputs = make_inputs()
        model = zoo.WCAModel(8)
        model.compile(optimizer="sgd", loss="mse", learning_rate=1e-2)
        # labels = current output, so the only gradient source on sigma
        # beyond the data term is the regularizer
        labels = model(inputs)[0]
        s0 = float(model.wca.sigma.value)
        for _ in range(10):
            model.train_on_batch(inputs, labels)
        assert float(model.wca.sigma.value) > s0


class TestConfigRoundtrip:
    def test_mol_model_config(self):
        m = zoo.LJMolModel(MN=2, mol_indices=[[0, 1], [2]],
                           nneighbor_cutoff=4)
        c = m.get_config()
        assert c["MN"] == 2
        # indices are stored 1-indexed and padded (reference convention)
        assert c["mol_indices"] == [[1, 2], [3, 0]]
        m2 = zoo.LJMolModel.from_config(
            {**c, "mol_indices": [[0, 1], [2]]})
        assert m2.MN == 2

    def test_eds_layer_config(self):
        layer = htf.EDSLayer(4.0, 5, learning_rate=0.2)
        c = layer.get_config()
        assert c["period"] == 5 and c["learning_rate"] == 0.2
        layer2 = htf.EDSLayer(**c)
        assert layer2.period == 5


class TestCheckNlist:
    def test_overflow_raises_eager(self):
        # crowd particles so every slot fills
        n, NN = 9, 2
        pos = np.zeros((n, 4), dtype=np.float32)
        pos[:, 0] = np.linspace(0, 0.8, n)  # all within r_cut of each other
        box_l = np.array([10.0, 10, 10], np.float32)
        nlist = htf.compute_nlist(jnp.asarray(pos), 3.0, NN, box_l,
                                  sorted=True, return_types=True)
        model = zoo.LJModel(NN, check_nlist=True)
        with pytest.raises(ValueError):
            model([nlist, jnp.asarray(pos), htf.box_from_lengths(box_l)])


class TestSkewGuard:
    def test_skewed_box_raises(self):
        inputs = make_inputs()
        box = np.array(inputs[2])
        box[2] = [0.5, 0, 0]
        model = zoo.LJModel(8)
        with pytest.raises(ValueError):
            model([inputs[0], inputs[1], jnp.asarray(box)])


class TestSerialization:
    def test_save_load_roundtrip(self, tmp_path):
        inputs = make_inputs()
        model = zoo.TrainableGraph(8)
        out0 = np.asarray(model(inputs)[0])
        path = str(tmp_path / "model.pkl")
        htf.save_model(model, path)
        loaded = htf.load_model(
            path, custom_objects_arg={"TrainableGraph": zoo.TrainableGraph})
        out1 = np.asarray(loaded(inputs)[0])
        np.testing.assert_allclose(out0, out1, rtol=1e-6)

    def test_lazy_built_roundtrip(self, tmp_path):
        inputs = make_inputs()
        model = zoo.NlistNN(8, dim=4, top_neighs=4)
        out0 = np.asarray(model(inputs)[0])
        path = str(tmp_path / "model.pkl")
        htf.save_model(model, path)

        class NlistNN2(zoo.NlistNN):
            pass

        loaded = htf.load_model(
            path, custom_objects_arg={"NlistNN": zoo.NlistNN},
            build_inputs=inputs)
        out1 = np.asarray(loaded(inputs)[0])
        np.testing.assert_allclose(out0, out1, rtol=1e-5, atol=1e-6)

    def test_get_config(self):
        model = zoo.LJModel(8, virial=True, check_nlist=True)
        c = model.get_config()
        assert c["nneighbor_cutoff"] == 8
        assert c["virial"] and c["check_nlist"]


class TestMolSimModel:
    def _mol_inputs(self):
        # 4 molecules of 3 atoms on a line
        n = 12
        pos = np.zeros((n, 4), dtype=np.float32)
        pos[:, 0] = np.arange(n) * 1.2 - 6
        pos[:, 1] = (np.arange(n) % 3) * 0.7
        box_l = np.array([20.0, 20, 20], np.float32)
        NN = 6
        nlist = htf.compute_nlist(jnp.asarray(pos), 2.5, NN, box_l,
                                  sorted=True, return_types=True)
        return [nlist, jnp.asarray(pos), htf.box_from_lengths(box_l)], NN

    def test_requires_mol_compute(self):
        with pytest.raises(AttributeError):
            htf.MolSimModel(3, [[0, 1, 2]], 4)

    def test_too_many_atoms_raises(self):
        class M(htf.MolSimModel):
            def mol_compute(self, nlist, positions, mol_nlist):
                return jnp.sum(mol_nlist)

        with pytest.raises(ValueError):
            M(2, [[0, 1, 2]], 4)

    def test_too_few_args_raises(self):
        class M(htf.MolSimModel):
            def mol_compute(self, nlist, positions):
                return jnp.sum(nlist)

        with pytest.raises(AttributeError):
            M(3, [[0, 1, 2]], 4)

    def test_mol_views(self):
        inputs, NN = self._mol_inputs()
        mol_indices = [[3 * i, 3 * i + 1, 3 * i + 2] for i in range(4)]

        class Views(htf.MolSimModel):
            def mol_compute(self, nlist, positions, mol_nlist, mol_pos):
                return mol_pos, mol_nlist

        m = Views(3, mol_indices, NN)
        mol_pos, mol_nlist = m(inputs)
        assert mol_pos.shape == (4, 3, 4)
        assert mol_nlist.shape == (4, 3, NN, 4)
        pos = np.asarray(inputs[1])
        np.testing.assert_allclose(np.asarray(mol_pos)[1, 2], pos[5])

    def test_padding_dummy_atom(self):
        inputs, NN = self._mol_inputs()
        # ragged molecules, padded with the dummy slot
        mol_indices = [[0, 1, 2], [3, 4], [5], [6, 7, 8], [9, 10, 11]]

        class Views(htf.MolSimModel):
            def mol_compute(self, nlist, positions, mol_nlist, mol_pos):
                return (mol_pos,)

        m = Views(3, mol_indices, NN)
        mol_pos = np.asarray(m(inputs)[0])
        assert mol_pos.shape == (5, 3, 4)
        np.testing.assert_allclose(mol_pos[1, 2], 0.0)  # padded slot
        np.testing.assert_allclose(mol_pos[2, 1:], 0.0)

    def test_mol_forces_flow(self):
        inputs, NN = self._mol_inputs()
        mol_indices = [[3 * i, 3 * i + 1, 3 * i + 2] for i in range(4)]
        m = zoo.LJMolModel(MN=3, mol_indices=mol_indices,
                           nneighbor_cutoff=NN)
        forces = np.asarray(m(inputs)[0])
        assert forces.shape == (12, 4)
        assert np.abs(forces[:, :3]).sum() > 0
        np.testing.assert_allclose(forces[:, :3].sum(axis=0), np.zeros(3),
                                   atol=1e-3)

    def test_reverse_indices(self):
        from hoomd_tf_tpu.models.simmodel import _make_reverse_indices
        mol_indices = [[1, 2, 0], [3, 0, 0]]  # already 1-indexed + padded
        rmi = _make_reverse_indices(mol_indices)
        assert rmi[0] == [0, 0]
        assert rmi[1] == [0, 1]
        assert rmi[2] == [1, 0]


class TestMolFeatures:
    def test_bond_angle_dihedral(self):
        # a square in the xy plane: known bond lengths and angles
        mol_pos = np.zeros((1, 4, 4), dtype=np.float32)
        mol_pos[0, 0, :3] = [0, 0, 0]
        mol_pos[0, 1, :3] = [1, 0, 0]
        mol_pos[0, 2, :3] = [1, 1, 0]
        mol_pos[0, 3, :3] = [0, 1, 0.5]
        box = htf.box_from_lengths([100.0, 100, 100])
        r = htf.mol_bond_distance(jnp.asarray(mol_pos), 0, 1, box=box)
        np.testing.assert_allclose(np.asarray(r), [1.0], rtol=1e-5)
        a = htf.mol_angle(jnp.asarray(mol_pos), 0, 1, 2, box=box)
        np.testing.assert_allclose(np.asarray(a), [np.pi / 2], rtol=1e-5)
        d = htf.mol_dihedral(jnp.asarray(mol_pos), 0, 1, 2, 3, box=box)
        assert np.all(np.isfinite(np.asarray(d)))
