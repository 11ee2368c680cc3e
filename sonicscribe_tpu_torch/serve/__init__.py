"""Serving: the async engine, file transcription and (in serve/app.py,
the only module that imports aiohttp) the HTTP application."""
