"""Host-side data handling: the evaluation transform."""
