from .app import App, Request, Response, TestClient

__all__ = ["App", "Request", "Response", "TestClient"]
