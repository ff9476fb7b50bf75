"""Host-side cryptography of the port that runs without the card."""
