"""FedNano port benchmark harness (see ``run.py``)."""
