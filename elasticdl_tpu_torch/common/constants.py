"""The constants of ``elasticdl_tpu/common/constants.py`` that the port
uses so far (the model zoo's contract)."""


class Mode:
    TRAINING = "training"
    EVALUATION = "evaluation"
    PREDICTION = "prediction"


class MetricsDictKey:
    MODEL_OUTPUT = "output"
    LABEL = "label"
