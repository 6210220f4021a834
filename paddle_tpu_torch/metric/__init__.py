"""paddle.metric of the port (paddle_tpu/metric): Metric, Accuracy,
Precision, Recall, Auc and the accuracy function."""
from .metrics import Metric, Accuracy, Precision, Recall, Auc, accuracy  # noqa: F401
