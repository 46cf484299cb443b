"""The port's OpenAI-style HTTP server."""
