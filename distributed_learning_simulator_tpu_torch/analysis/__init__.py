from .session import GraphSession, Session
from .analyze_log import CommunicationCostModel

__all__ = ["Session", "GraphSession", "CommunicationCostModel"]
