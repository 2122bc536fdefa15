"""Entry points (port of `repro.launch`): token serving so far."""
