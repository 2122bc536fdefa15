"""The paper's evaluation data flows (`flows.py`), ported."""
