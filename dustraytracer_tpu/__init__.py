"""The package's former import name, kept as an alias of `dustraytracer`.

`import <this name>.x.y` returns the module `dustraytracer.x.y` itself,
so code written against the old name keeps working and shares every
module, class and jit cache with code that uses the new one.
"""

import importlib
import importlib.abc
import importlib.util
import sys

_OLD = __name__
_NEW = "dustraytracer"


class _Alias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    def find_spec(self, name, path=None, target=None):
        if name.startswith(_OLD + "."):
            return importlib.util.spec_from_loader(name, self)
        return None

    def create_module(self, spec):
        module = importlib.import_module(_NEW + spec.name[len(_OLD):])
        spec.loader_state = module.__spec__
        return module

    def exec_module(self, module):
        # the import system stamped the alias spec on the shared module
        module.__spec__ = module.__spec__.loader_state


sys.meta_path.insert(0, _Alias())
sys.modules[_OLD] = importlib.import_module(_NEW)
