"""The Celeris recovery layer: the Hadamard code and the transport coupling."""
