"""The benchmark's reference, written for it and importing nothing of the
port: CometBFT hashing from the specification (``cometbft``) and a reader
of the proof's wire form (``wire``)."""
