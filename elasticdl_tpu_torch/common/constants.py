"""The constants of ``elasticdl_tpu/common/constants.py`` that the port
uses, values copied: the model zoo's contract, the task types the master
dispatches and the job's configuration enums."""

import enum


class TaskType(enum.IntEnum):
    """Task types dispatched by the master. WAIT tells a worker to stand
    by because new tasks (a deferred SAVE_MODEL task) may still arrive."""

    TRAINING = 0
    EVALUATION = 1
    PREDICTION = 2
    WAIT = 3
    SAVE_MODEL = 4


class Mode:
    TRAINING = "training"
    EVALUATION = "evaluation"
    PREDICTION = "prediction"


class JobType:
    TRAINING_ONLY = "training_only"
    EVALUATION_ONLY = "evaluation_only"
    PREDICTION_ONLY = "prediction_only"
    TRAINING_WITH_EVALUATION = "training_with_evaluation"


class DistributionStrategy:
    PARAMETER_SERVER = "ParameterServerStrategy"
    ALLREDUCE = "AllreduceStrategy"
    LOCAL = "Local"


class MetricsDictKey:
    MODEL_OUTPUT = "output"
    LABEL = "label"


class SaveModelConfig:
    SAVED_MODEL_PATH = "saved_model_path"


class TaskExecCounterKey:
    FAIL_COUNT = "fail_count"
    # the worker's model version, piggybacked on task reports so the
    # coordinating (ALLREDUCE) master, which applies no gradients, can
    # follow it
    MODEL_VERSION = "model_version"
    # the dispatcher's trace id and attempt of the acknowledged task
    TRACE_ID = "trace_id"
    ATTEMPT = "attempt"


class ODPSConfig:
    PROJECT_NAME = "ODPS_PROJECT_NAME"
    ACCESS_ID = "ODPS_ACCESS_ID"
    ACCESS_KEY = "ODPS_ACCESS_KEY"
    ENDPOINT = "ODPS_ENDPOINT"
