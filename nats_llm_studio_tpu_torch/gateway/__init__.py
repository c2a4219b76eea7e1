from .server import Gateway, translate_chat_payload

__all__ = ["Gateway", "translate_chat_payload"]
