from .orchestrator import Orchestrator, OrchestratorConfig  # noqa: F401
