from repro_torch.agents.base import BaseAgent, Workflow
from repro_torch.agents.messaging import Headers, Message, MessageBus

__all__ = ["BaseAgent", "Workflow", "Headers", "Message", "MessageBus"]
