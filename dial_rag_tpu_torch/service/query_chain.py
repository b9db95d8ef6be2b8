"""Standalone-question extraction (mirror of reference query_chain.py):
single-turn conversations use the last message as-is; multi-turn ones ask
the LLM (forced function call) to reformulate, with a fallback to the
last message on any failure."""

import logging

from dial_rag_tpu_torch.service.config import QueryChainConfig
from dial_rag_tpu_torch.service.history import get_number_of_user_messages
from dial_rag_tpu_torch.service.llm import LlmClient
from dial_rag_tpu_torch.service.protocol import TimedStage
from dial_rag_tpu_torch.service.request_context import RequestContext

logger = logging.getLogger(__name__)

# PROVENANCE: prompt + tool schema intentionally pinned verbatim to the
# reference's standalone-question chain (reference query_chain.py) —
# recorded LLM replay caches key on the exact prompt bytes, and the
# reformulation behavior is a contract the retrieval goldens depend on.
QUERY_SYSTEM_TEMPLATE = """
Given a chat history and the latest user question which might reference context in the chat history, formulate a standalone question which can be understood without the chat history.
Do NOT answer the question, just reformulate it if needed and otherwise return it as is.
Call the StandaloneQuestionCallback to return the reformulated standalone question.
"""

STANDALONE_QUESTION_TOOL = {
    "name": "StandaloneQuestionCallback",
    "description": "Return the reformulated standalone question.",
    "parameters": {
        "type": "object",
        "properties": {
            "question": {
                "type": "string",
                "description": "reformulated standalone question",
            }
        },
        "required": ["question"],
    },
}


async def get_query(
    request_context: RequestContext,
    config: QueryChainConfig,
    chat_history: list[dict],
) -> str:
    """Returns the retrieval query, reporting it in a stage."""
    async with TimedStage(
        request_context.choice, "Standalone question"
    ) as stage:
        query = chat_history[-1]["content"] if chat_history else ""

        if config.use_history and get_number_of_user_messages(chat_history) > 1:
            llm = LlmClient(
                request_context.dial_url, request_context.api_key, config.llm
            )
            try:
                args = await llm.call_function(
                    [{"role": "system", "content": QUERY_SYSTEM_TEMPLATE}]
                    + chat_history,
                    **STANDALONE_QUESTION_TOOL,
                )
                query = args["question"]
            except Exception as e:
                logger.warning(f"Failed to extract query: {e}")

        stage.append_content(query)
        return query
