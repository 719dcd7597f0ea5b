"""Entry points of the port's LM side: step builders and the serving launcher."""
