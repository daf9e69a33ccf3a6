from .model import SysLearner, SysLearnerConfig, build_syslearner  # noqa: F401
