"""The paper's 5-UE federated system (§V) and the host reference path:
clients (``client``), the base station (``server``), the §V run with its
baselines, the host-stepped fleet path and the dispatch between them
(``system``)."""
