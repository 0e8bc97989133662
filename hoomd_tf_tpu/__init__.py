"""hoomd_tf_tpu (``htf``): a machine-learning molecular-dynamics engine in
JAX that runs on the GPU, with the capabilities of ur-whitelab/hoomd-tf.

Where the reference couples two engines (HOOMD-blue and TensorFlow) through a
zero-copy GPU buffer scheme, this framework is a single engine: simulation
state lives in device-resident ``jax.Array`` s, and one jitted step fuses the
neighbor-list build, ``SimModel.compute`` force evaluation and integration
(see SURVEY.md section 7). The user-facing API keeps the reference's
conventions so models written against hoomd-tf transfer directly.

Typical use::

    import hoomd_tf_tpu as htf

    class LJModel(htf.SimModel):
        def compute(self, nlist, positions, box):
            rinv = htf.nlist_rinv(nlist)
            inv_r6 = rinv ** 6
            p_energy = 4.0 / 2.0 * (inv_r6 * inv_r6 - inv_r6)
            energy = p_energy.sum(axis=1)
            return htf.compute_nlist_forces(nlist, energy)

    model = LJModel(64)
    sim = htf.Simulation(dt=0.005, integrator=htf.md.NVT(kT=1.2, tau=0.5))
    sim.init_lattice(n=256, density=0.4, kT_init=1.2)
    tfc = htf.tfcompute(model)
    tfc.attach(sim, r_cut=3.0)
    sim.run(1000)
"""

__version__ = "0.1.0"

# runtime version gate (the analog of the reference's build-time
# check_tf_version.py): fail fast on a jax older than the one this package
# is tested with (jax.shard_map, the Pallas Triton route).
def _check_jax_version():
    import jax as _jax
    minimum = (0, 9, 0)
    parts = tuple(int(p) for p in _jax.__version__.split(".")[:3]
                  if p.isdigit())
    if parts < minimum:
        raise ImportError(
            f"hoomd_tf_tpu requires jax >= {'.'.join(map(str, minimum))}, "
            f"found {_jax.__version__}")


_check_jax_version()

from .ops import (box_size, wrap_vector, make_box, box_from_lengths,
                  safe_norm, nlist_rinv, masked_nlist, divide_no_nan,
                  multiply_no_nan, compute_nlist_forces,
                  compute_positions_forces, compute_nlist,
                  nlist_from_positions, CellList, cell_list_nlist,
                  NlistPlanes, direct_cell_planes, Cellwise,
                  compute_rdf)
from .models import (Variable, Layer, Mean, MeanTensor, SimModel, MolSimModel,
                     PairModel,
                     RBFExpansion, WCARepulsion, EDSLayer, Dense,
                     LJPotential, TrainableLJ, NeuralPairPotential)
from . import ops
from . import models

# populated by later imports at the bottom to avoid cycles
from . import md
from .md.simulation import Simulation
from .driver import tfcompute
from . import parallel
from . import utils
from .utils.cg import (find_molecules, find_molecules_from_topology,
                       matrix_mapping, sparse_mapping, center_of_mass,
                       gen_mapped_exclusion_list, gen_bonds_group,
                       compute_ohe_bead_type_interactions)
from .utils.graph import (compute_adj_mat, compute_cg_graph, find_cgnode_id,
                          mol_features_multiple)
from .utils.mol_features import mol_bond_distance, mol_angle, mol_dihedral
from .utils.trajectory import iter_from_trajectory, compute_pairwise, \
    create_frame
from .utils.gsd_io import GSDFile, GSDUniverse, write_gsd_frames
from .serialize import save_model, load_model, custom_objects

__all__ = [
    "box_size", "wrap_vector", "make_box", "box_from_lengths",
    "safe_norm", "nlist_rinv", "masked_nlist", "divide_no_nan",
    "multiply_no_nan", "compute_nlist_forces", "compute_positions_forces",
    "compute_nlist", "nlist_from_positions", "CellList", "cell_list_nlist",
    "NlistPlanes", "direct_cell_planes", "Cellwise", "compute_rdf",
    "Variable", "Layer", "Mean", "MeanTensor", "SimModel", "MolSimModel",
    "PairModel",
    "RBFExpansion", "WCARepulsion", "EDSLayer", "Dense",
    "LJPotential", "TrainableLJ", "NeuralPairPotential",
    "Simulation", "tfcompute",
    "find_molecules", "find_molecules_from_topology", "matrix_mapping",
    "sparse_mapping", "center_of_mass", "gen_mapped_exclusion_list",
    "gen_bonds_group", "compute_ohe_bead_type_interactions",
    "compute_adj_mat", "compute_cg_graph", "find_cgnode_id",
    "mol_features_multiple", "mol_bond_distance", "mol_angle", "mol_dihedral",
    "iter_from_trajectory", "compute_pairwise", "create_frame",
    "GSDFile", "GSDUniverse", "write_gsd_frames",
    "save_model", "load_model", "custom_objects",
    "md", "ops", "models", "parallel", "utils",
]
