"""The fixture chain generator, frozen from the port at commit a7cc570
(``testchain.py`` and the types it builds on, ``tendermint.py``)."""
