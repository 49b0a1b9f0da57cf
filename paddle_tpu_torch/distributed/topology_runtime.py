"""The global mesh registry — counterpart of
`paddle_tpu/distributed/topology_runtime.py`: `build_mesh`, `set_mesh`,
`get_mesh`, `axis_size` and `mesh_axis_names`.

The port runs on one card, so a mesh is a registry of named axes at
degree 1: `build_mesh(['dp', 'sharding'], [1, 1])` registers it (as
bench.py's BERT leg does), and an axis above 1 raises
NotImplementedError; meshes over several cards come with the multi-GPU
port (ROADMAP Queue 1 item 7).
"""
_current_mesh = None

_MULTI = 'meshes over several cards, ROADMAP Queue 1 item 7'


class Mesh:
    """Named axes, each of size 1: `axis_names` (outermost first) and
    `shape` ({axis: size}), as jax.sharding.Mesh exposes them."""

    def __init__(self, axis_names, axis_sizes, devices=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names,
                              (int(n) for n in axis_sizes)))
        self.devices = devices

    def __repr__(self):
        return f'Mesh({self.shape})'


def set_mesh(mesh):
    global _current_mesh
    _current_mesh = mesh
    return mesh


def get_mesh():
    return _current_mesh


def build_mesh(axis_names, axis_sizes, devices=None):
    """Create and register a mesh; every axis must have size 1."""
    axis_names, axis_sizes = list(axis_names), list(axis_sizes)
    if len(axis_names) != len(axis_sizes):
        raise ValueError(f'{len(axis_names)} axis names for '
                         f'{len(axis_sizes)} sizes')
    big = {a: n for a, n in zip(axis_names, axis_sizes) if int(n) > 1}
    if big:
        raise NotImplementedError(
            f'build_mesh: axes {big} above 1 are not ported yet ({_MULTI})')
    return set_mesh(Mesh(axis_names, axis_sizes, devices))


def axis_size(axis):
    if _current_mesh is not None and axis in _current_mesh.shape:
        return _current_mesh.shape[axis]
    return 1


def mesh_axis_names():
    return tuple(_current_mesh.axis_names) if _current_mesh is not None \
        else ()
