"""Name -> class registry (counterpart of codeformer_tpu/utils/registry.py),
so configs select components by `type:` name. The port keeps its own
instances and its own class: it imports nothing of the JAX package."""


class Registry:
    """A name -> object mapping filled by decorator::

        ARCH_REGISTRY = Registry('arch')

        @ARCH_REGISTRY.register()
        class CodeFormer: ...

        cls = ARCH_REGISTRY.get('CodeFormer')
    """

    def __init__(self, name: str):
        self._name = name
        self._obj_map: dict[str, object] = {}

    def register(self):
        def deco(obj):
            if obj.__name__ in self._obj_map:
                raise KeyError(f"An object named '{obj.__name__}' was "
                               f"already registered in '{self._name}' "
                               f"registry!")
            self._obj_map[obj.__name__] = obj
            return obj
        return deco

    def get(self, name: str):
        if name not in self._obj_map:
            raise KeyError(f"No object named '{name}' found in "
                           f"'{self._name}' registry! Available: "
                           f"{sorted(self._obj_map)}")
        return self._obj_map[name]

    def __contains__(self, name: str) -> bool:
        return name in self._obj_map


ARCH_REGISTRY = Registry('arch')
MODEL_REGISTRY = Registry('model')   # trainers, by `model_type:`
DATASET_REGISTRY = Registry('dataset')   # data/, by a dataset's `type:`
METRIC_REGISTRY = Registry('metric')     # metrics/, by a metric's `type:`

__all__ = ['Registry', 'ARCH_REGISTRY', 'MODEL_REGISTRY', 'DATASET_REGISTRY',
           'METRIC_REGISTRY']
