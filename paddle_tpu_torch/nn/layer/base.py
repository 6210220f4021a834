"""ParamAttr (port of paddle_tpu/nn/layer/base.py): a parameter's name,
initializer, learning-rate multiplier, regularizer, trainable flag and
need_clip, read by Layer.create_parameter."""
from __future__ import annotations

__all__ = ["ParamAttr"]


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=False,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip
