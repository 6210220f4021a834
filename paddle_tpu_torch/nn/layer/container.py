"""Sequential and LayerList (port of paddle_tpu/nn/layer/container.py).

Sequential takes layers (named "0", "1", ...), `(name, layer)` tuples,
or one list of such tuples, and runs them in order; LayerList holds
layers under "0", "1", ... without running them. Sublayer names, and so
state-dict names, are the JAX package's."""
from __future__ import annotations

from .layers import Layer

__all__ = ["Sequential", "LayerList"]


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

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def append(self, layer):
        self.add_sublayer(str(len(self)), layer)
        return self
