"""String-keyed plugin registries.

The port's own copy of ``savsr_tpu/utils/registry.py`` (the design of the
reference registry, lbasicsr/utils/registry.py:1-62): YAML configs name
components by string and the pipelines resolve them through global
registries, so dataset/arch/model/loss plugins stay decoupled from the
generic train pipeline.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Tuple


class Registry:
    """A name -> object mapping supporting decorator-style registration.

    Usage::

        MODEL_REGISTRY = Registry('model')

        @MODEL_REGISTRY.register()
        class MyModel: ...

        cls = MODEL_REGISTRY.get('MyModel')
    """

    def __init__(self, name: str):
        self._name = name
        self._objects: Dict[str, Any] = {}

    @property
    def name(self) -> str:
        return self._name

    def _do_register(self, name: str, obj: Any, suffix: str | None = None) -> None:
        if suffix is not None:
            name = f"{name}_{suffix}"
        if name in self._objects:
            raise KeyError(
                f"An object named '{name}' is already registered in the "
                f"'{self._name}' registry."
            )
        self._objects[name] = obj

    def register(self, obj: Any = None, suffix: str | None = None) -> Callable | Any:
        """Register ``obj``; usable bare or as a decorator."""
        if obj is None:

            def decorator(fn_or_class: Any) -> Any:
                self._do_register(fn_or_class.__name__, fn_or_class, suffix)
                return fn_or_class

            return decorator
        self._do_register(obj.__name__, obj, suffix)
        return obj

    def get(self, name: str, suffix: str = "savsr_tpu_torch") -> Any:
        """Look up by name; falls back to ``<name>_<suffix>`` (mirrors the
        reference's ``_lbasicsr`` suffix fallback, registry.py:38-45)."""
        obj = self._objects.get(name)
        if obj is None:
            obj = self._objects.get(f"{name}_{suffix}")
        if obj is None:
            raise KeyError(
                f"No object named '{name}' in the '{self._name}' registry. "
                f"Available: {sorted(self._objects)}"
            )
        return obj

    def __contains__(self, name: str) -> bool:
        return name in self._objects

    def __iter__(self) -> Iterator[Tuple[str, Any]]:
        return iter(self._objects.items())

    def keys(self):
        return self._objects.keys()


DATASET_REGISTRY = Registry("dataset")
MODEL_REGISTRY = Registry("model")
LOSS_REGISTRY = Registry("loss")
