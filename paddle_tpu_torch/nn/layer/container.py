"""Layer containers (port of paddle_tpu/nn/layer/container.py):
Sequential, LayerList, ParameterList and LayerDict.

Sequential takes layers (named "0", "1", ...), `(name, layer)` tuples,
or one list of such tuples, and runs them in order; LayerList holds
layers under "0", "1", ... without running them (renumbered after an
insert or a delete); ParameterList holds parameters under "0", "1",
...; LayerDict holds layers under their keys, in insertion order.
Sublayer and parameter names, and so state-dict names, are the JAX
package's."""
from __future__ import annotations

from .layers import Layer

__all__ = ["Sequential", "LayerList", "ParameterList", "LayerDict"]


class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) \
                and layers[0] and isinstance(layers[0][0], tuple):
            layers = tuple(layers[0])
        for i, layer in enumerate(layers):
            if isinstance(layer, tuple):
                self.add_sublayer(layer[0], layer[1])
            else:
                self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        layers = list(self._modules.values())
        if isinstance(idx, slice):
            return Sequential(*layers[idx])
        return layers[idx]

    def __setitem__(self, idx, layer):
        self._modules[list(self._modules)[idx]] = layer

    def __delitem__(self, idx):
        del self._modules[list(self._modules)[idx]]

    def __len__(self):
        return len(self._modules)

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        for layer in sublayers or ():
            self.append(layer)

    def __getitem__(self, idx):
        layers = list(self._modules.values())
        if isinstance(idx, slice):
            return LayerList(layers[idx])
        return layers[idx]

    def __setitem__(self, idx, layer):
        if idx < 0:
            idx += len(self)
        self._modules[str(idx)] = layer

    def __delitem__(self, idx):
        layers = list(self._modules.values())
        del layers[idx]
        self._renumber(layers)

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def _renumber(self, layers):
        self._modules.clear()
        for i, layer in enumerate(layers):
            self._modules[str(i)] = layer

    def append(self, layer):
        self.add_sublayer(str(len(self)), layer)
        return self

    def insert(self, index, layer):
        layers = list(self._modules.values())
        layers.insert(index, layer)
        self._renumber(layers)

    def extend(self, layers):
        for layer in layers:
            self.append(layer)
        return self


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        for p in parameters or ():
            self.append(p)

    def __getitem__(self, idx):
        return self._parameters[str(idx)]

    def __setitem__(self, idx, param):
        self._parameters[str(idx)] = param

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, parameter):
        self.add_parameter(str(len(self)), parameter)
        return self


class LayerDict(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)

    def __getitem__(self, key):
        return self._modules[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __delitem__(self, key):
        del self._modules[key]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules)

    def __contains__(self, key):
        return key in self._modules

    def clear(self):
        self._modules.clear()

    def pop(self, key):
        return self._modules.pop(key)

    def keys(self):
        return self._modules.keys()

    def items(self):
        return self._modules.items()

    def values(self):
        return self._modules.values()

    def update(self, sublayers):
        pairs = sublayers.items() if isinstance(sublayers, dict) \
            else sublayers
        for k, v in pairs:
            self.add_sublayer(k, v)
        return self
