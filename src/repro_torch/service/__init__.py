"""Serving layer of the port: so far only the batch lane
(``service.batch``)."""
