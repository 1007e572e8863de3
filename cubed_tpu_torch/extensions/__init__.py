from ..observability import TracingCallback  # noqa: F401
from .history import HistoryCallback  # noqa: F401
from .timeline import TimelineVisualizationCallback  # noqa: F401
from .tqdm import TqdmProgressBar  # noqa: F401
