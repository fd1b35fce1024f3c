// DataSheets (reference pages/DataSheets): the combined read view over
// data + code source records — one tabbed sheet with per-row actions,
// including "use in job" which prefills the creation wizard. CRUD lives
// on the per-kind config pages (#/datasources, #/codesources).
import { api, esc, navigate, t, tabbed } from "../app.js";

function sheet(el, rows, cols, useParam, emptyLabel) {
  el.innerHTML = `
    <table><thead><tr>
      ${cols.map(c => `<th>${esc(c.label)}</th>`).join("")}<th></th>
    </tr></thead><tbody>
      ${Object.values(rows).map(r => `<tr>
        ${cols.map(c => `<td class="${c.muted ? "muted" : ""}">
          ${esc(r[c.key])}</td>`).join("")}
        <td class="actions">
          <button class="ghost" data-use="${esc(r.name)}">
            ${esc(t("sheets.use"))}</button>
          <button class="danger" data-del="${esc(r.name)}">
            ${esc(t("jobs.delete"))}</button></td>
      </tr>`).join("")}
    </tbody></table>
    ${Object.keys(rows).length ? "" :
      `<p class="muted">${esc(emptyLabel)}</p>`}`;
  el.querySelectorAll("[data-use]").forEach(btn => btn.onclick = () =>
    navigate(`#/job-create?${useParam}=${encodeURIComponent(
      btn.dataset.use)}`));
  return el;
}

export async function viewDataSheets(app) {
  app.innerHTML = `
    <div class="panel">
      <div class="row"><h2 style="margin:0">${esc(t("sheets.title"))}</h2>
        <span style="flex:1"></span>
        <a href="#/datasources">${esc(t("sources.data"))}</a>
        <a href="#/codesources">${esc(t("sources.code"))}</a>
      </div>
      <div id="sheet-tabs"></div>
    </div>`;
  const wire = (el, base) => {
    el.querySelectorAll("[data-del]").forEach(btn => btn.onclick =
      async () => {
        await api(`${base}/${encodeURIComponent(btn.dataset.del)}`,
                  { method: "DELETE" });
        viewDataSheets(app);
      });
  };
  tabbed(document.getElementById("sheet-tabs"), [
    { id: "data", label: t("sources.data"), render: async el => {
        const rows = await api("/datasource");
        sheet(el, rows, [
          { key: "name", label: "Name" },
          { key: "type", label: "Type", muted: true },
          { key: "pvc_name", label: "PVC" },
          { key: "local_path", label: "Mount path", muted: true },
          { key: "description", label: "Description", muted: true },
        ], "data", t("sheets.noData"));
        wire(el, "/datasource");
      } },
    { id: "code", label: t("sources.code"), render: async el => {
        const rows = await api("/codesource");
        sheet(el, rows, [
          { key: "name", label: "Name" },
          { key: "type", label: "Type", muted: true },
          { key: "code_path", label: "Repo" },
          { key: "default_branch", label: "Branch", muted: true },
          { key: "local_path", label: "Clone path", muted: true },
        ], "code", t("sheets.noCode"));
        wire(el, "/codesource");
      } },
  ]);
}
